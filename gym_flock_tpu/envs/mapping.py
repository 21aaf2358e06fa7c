"""Mapping (target-observation) environment family — pure-JAX.

Batched, jit-compiled re-design of the reference's ``old/`` mapping envs (SURVEY.md
§2.2 #22), the predecessors of the spatial coverage family:

* ``MappingEnv``      — reference old/mapping.py:15-267 (double integrator,
  7-NN agent + 7 nearest-unobserved-target observations, scalar reward
  ``10 * newly_observed - dist_traveled``)
* ``MappingVelEnv``   — reference old/mapping_vel.py:15-262 (single
  integrator, 4-NN, per-agent reward: the NEAREST agent is credited for
  each newly observed target, minus 0.1 * per-agent distance traveled)
* ``MappingDiscEnv``  — reference old/mapping_disc.py:15-270 (discrete
  action: index into the 4 nearest-unobserved-target directions)
* ``MappingLocalEnv`` — reference old/mapping_local.py:15-272 (double
  integrator, own velocity prepended to the observation)

The reference compacts the target arrays every step
(``target_x[target_unobserved]`` — a dynamic shape, old/mapping.py:194).
Here the target set is a STATIC ``[T, 2]`` buffer with an ``unobserved``
mask; observed targets get ``+inf`` masked distances, which reproduces the
compacted argsort/argpartition selection exactly while keeping every shape
known to XLA (same padding philosophy the reference itself adopts in
coverage.py MAX_NODES).

Replicated quirks (verified against the reference by tests):

* the adjacency "union-column" write ``adj_mat[:, nearest[:, i]] = 1.0``
  (old/mapping.py:186) sets whole COLUMNS — every agent sees an edge to any
  agent that is in anyone's k-NN list.  The base env additionally leaves the
  resulting self-loops on the diagonal; vel/disc/local zero them
  (old/mapping_vel.py:174).
* when fewer than k unobserved targets remain, the trailing observation
  slots stay zero (old/mapping.py:204).
* per-agent credit uses duplicate fancy-index assignment ``+= 1``
  (old/mapping_vel.py:211) — an agent nearest to SEVERAL newly observed
  targets still gets exactly +1.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from gym_flock_tpu.core import struct

from gym_flock_tpu.core.env import Env, EnvState
from gym_flock_tpu.core.spaces import Box, Discrete

__all__ = [
    "MappingParams",
    "MappingState",
    "MappingEnv",
    "MappingVelEnv",
    "MappingDiscEnv",
    "MappingLocalEnv",
    "make_target_grid",
]


def make_target_grid(n_agents: int, px_max: float, py_max: float) -> np.ndarray:
    """[n_agents^2, 2] meshgrid target lattice (reference old/mapping.py:74-83)."""
    x = np.linspace(-px_max, px_max, n_agents)
    y = np.linspace(-py_max, py_max, n_agents)
    tx, ty = np.meshgrid(x, y)
    return np.stack((tx.ravel(), ty.ravel()), axis=1)


@struct.dataclass
class MappingParams:
    """Defaults mirror reference old/mapping.py:24-92."""

    # --- static ---
    n_agents: int = struct.field(pytree_node=False, default=100)
    nearest_agents: int = struct.field(pytree_node=False, default=7)
    nearest_targets: int = struct.field(pytree_node=False, default=7)
    mean_pooling: bool = struct.field(pytree_node=False, default=True)
    max_steps: int = struct.field(pytree_node=False, default=1000)
    # variant switches (see class docstrings)
    double_integrator: bool = struct.field(pytree_node=False, default=True)
    neighbor_dims: int = struct.field(pytree_node=False, default=4)  # 4 or 2
    per_agent_reward: bool = struct.field(pytree_node=False, default=False)
    zero_adj_diag: bool = struct.field(pytree_node=False, default=False)
    observe_self_vel: bool = struct.field(pytree_node=False, default=False)
    observe_neighbors: bool = struct.field(pytree_node=False, default=True)
    discrete_actions: bool = struct.field(pytree_node=False, default=False)
    # bit-exact parity mode (see flocking_features_exact for the
    # technique): integration, pairwise r2, the traveled-distance norm
    # sum (NumPy's 8-way-unrolled pairwise order), and the greedy action
    # mirror the reference old/mapping.py op-for-op at x64.  Selection
    # (k-nearest) matches the reference's unstable argsort on all
    # UNTIED distances — an exact distance tie is the one case where the
    # reference's quicksort order is implementation-defined and therefore
    # unreproducible in principle.
    parity_exact: bool = struct.field(pytree_node=False, default=False)

    # --- dynamic ---
    dt: float = 0.1
    v_max: float = 5.0
    max_accel: float = 1.0  # max_vel for the single-integrator variants
    action_scalar: float = 10.0
    obs_rad: float = 2.0
    px_max: float = 100.0
    py_max: float = 100.0
    dist_penalty: float = 1.0  # 0.1 for the per-agent-reward variants
    reward_scale: float = 10.0  # 1.0 for the per-agent-reward variants
    # [T, 2] static target lattice (T = n_agents^2)
    target_x: Optional[jax.Array] = None

    @property
    def n_targets(self) -> int:
        return self.n_agents * self.n_agents

    @property
    def obs_rad2(self):
        return self.obs_rad * self.obs_rad


@struct.dataclass
class MappingState(EnvState):
    x: jax.Array  # [N, 4] (vel rows zero for single-integrator variants)
    unobserved: jax.Array  # [T] bool
    # nearest-unobserved-target diffs from the LAST observation pass: the
    # reference's greedy expert and discrete action table read the cached
    # ``obs_target``/``discrete_actions`` of the previous ``compute_helpers``
    # call (old/mapping.py:217, old/mapping_disc.py:224) — one pass STALE
    # relative to ``unobserved``.  Carried in the state to replicate exactly.
    last_obs_target: jax.Array  # [N, nearest_targets * 2]


def _mapping_helpers(x: jax.Array, unobserved: jax.Array, params: MappingParams):
    """Observation / reward kernel (reference old/mapping.py:167-222).

    Returns (state_values, state_network, obs_target, newly, credit).
    All pairwise work is dense-masked: [N,N] agent block plus an [N,T]
    agent-target block — both fused elementwise passes with static shapes.
    """
    n, ka, kt = params.n_agents, params.nearest_agents, params.nearest_targets

    # --- neighbors -------------------------------------------------------
    diff = x[:, None, :] - x[None, :, :]  # [N, N, 4]
    if params.parity_exact:
        from gym_flock_tpu.envs.flocking import _rnd

        r2 = _rnd(diff[:, :, 0] ** 2) + _rnd(diff[:, :, 1] ** 2)
    else:
        r2 = diff[:, :, 0] ** 2 + diff[:, :, 1] ** 2
    r2 = r2 + jnp.where(jnp.eye(n, dtype=bool), jnp.inf, 0.0)

    _, nearest = jax.lax.top_k(-r2, ka)  # [N, ka], ascending distance
    # gather each neighbor's diff: [N, ka, neighbor_dims]
    neigh_diff = jnp.take_along_axis(
        diff[:, :, : params.neighbor_dims], nearest[:, :, None], axis=1
    )
    obs_neigh = neigh_diff.reshape((n, ka * params.neighbor_dims))

    # union-column adjacency quirk (old/mapping.py:186): a column j is 1 for
    # EVERY row iff j appears in any agent's k-NN list
    col = jnp.zeros((n,)).at[nearest.reshape(-1)].set(1.0)
    adj = jnp.broadcast_to(col[None, :], (n, n))
    if params.zero_adj_diag:
        adj = adj * (1.0 - jnp.eye(n))
    n_neighbors = jnp.maximum(jnp.sum(adj, axis=1, keepdims=True), 1.0)
    network = adj / n_neighbors if params.mean_pooling else adj

    # --- targets ---------------------------------------------------------
    # The k nearest unobserved targets per agent.  NOT jax.lax.top_k over
    # the T = n_agents^2 = 10,000-wide target axis: instead run kt (= 7)
    # rounds of min + first-match-index — each round is a plain fused pass
    # over the RECOMPUTED [N, T] distance expression (nothing [N, T]-sized
    # is ever materialized; exclusions are <= kt-1 index compares per
    # element).  Exactly equivalent to stable top_k: among tied distances
    # the lower index wins each round, the next round takes the next one.
    tgt = params.target_x  # [T, 2]
    tn = tgt.shape[0]
    iota_t = jnp.arange(tn, dtype=jnp.int32)

    def _masked_r2(excl_idx):
        # [N, T] squared distances; inf where observed or already chosen.
        if params.parity_exact:
            from gym_flock_tpu.envs.flocking import _rnd

            r2_row = _rnd((x[:, None, 0] - tgt[None, :, 0]) ** 2) + _rnd(
                (x[:, None, 1] - tgt[None, :, 1]) ** 2
            )
        else:
            r2_row = (
                (x[:, None, 0] - tgt[None, :, 0]) ** 2
                + (x[:, None, 1] - tgt[None, :, 1]) ** 2
            )
        m = jnp.where(unobserved[None, :], r2_row, jnp.inf)
        for e in excl_idx:
            m = jnp.where(iota_t[None, :] == e[:, None], jnp.inf, m)
        return m

    chosen, min_r2 = [], []
    for _ in range(kt):
        r2_eff = _masked_r2(chosen)
        m = jnp.min(r2_eff, axis=1)  # [N]
        # first index attaining the min (all-inf rows hit index 0 — their
        # value is +inf and the entry is zeroed by `valid` below, matching
        # what top_k's arbitrary tie order produced after the same zeroing)
        idx = jnp.min(
            jnp.where(r2_eff == m[:, None], iota_t[None, :], tn), axis=1
        )
        idx = jnp.where(idx == tn, 0, idx).astype(jnp.int32)
        chosen.append(idx)
        min_r2.append(m)
    nearest_t = jnp.stack(chosen, axis=1)  # [N, kt]
    valid = jnp.isfinite(jnp.stack(min_r2, axis=1))  # [N, kt]

    tgt_diff = x[:, None, 0:2] - tgt[nearest_t]  # [N, kt, 2]
    tgt_diff = jnp.where(valid[:, :, None], tgt_diff, 0.0)
    obs_target = tgt_diff.reshape((n, kt * 2))

    r2_t_masked = _masked_r2([])  # fused into each consumer below
    col_min = jnp.min(r2_t_masked, axis=0)  # [T]
    newly = unobserved & (col_min < params.obs_rad2)  # [T]

    # per-agent credit: +1 iff nearest to >=1 newly observed target
    # (duplicate-index assignment semantics, old/mapping_vel.py:209-211).
    # First-match min instead of argmin: one single-value reduce instead of
    # a variadic (value, index) one (same routing as the coverage packed min).
    iota_n = jnp.arange(n, dtype=jnp.int32)
    nearest_agent = jnp.min(
        jnp.where(r2_t_masked == col_min[None, :], iota_n[:, None], n), axis=0
    )
    nearest_agent = jnp.where(nearest_agent == n, 0, nearest_agent)
    credit = jnp.zeros((n,)).at[nearest_agent].max(newly.astype(jnp.float32))

    values_parts = []
    if params.observe_self_vel:
        values_parts.append(x[:, 2:4])
    if params.observe_neighbors:
        values_parts.append(obs_neigh)
    values_parts.append(obs_target)
    state_values = jnp.concatenate(values_parts, axis=1)

    return state_values, network, obs_target, newly, credit


class MappingEnv(Env[MappingParams, MappingState]):
    """Continuous-dynamics target observation (reference old/mapping.py:15-267).

    N agents sweep an N^2 target lattice; a target is observed when any
    agent comes within ``obs_rad``.  Scalar reward
    ``10 * #newly_observed - total_dist_traveled``; done when all targets
    are observed.
    """

    def default_params(self) -> MappingParams:
        p = MappingParams()
        return p.replace(target_x=jnp.asarray(make_target_grid(p.n_agents, p.px_max, p.py_max)))

    # ------------------------------------------------------------ protocol

    def reset_env(self, key: jax.Array, params: MappingParams):
        n = params.n_agents
        kx, ky, kvx, kvy = jax.random.split(key, 4)
        px = jax.random.uniform(kx, (n,), minval=-params.px_max, maxval=params.px_max)
        py = jax.random.uniform(ky, (n,), minval=-params.py_max, maxval=params.py_max)
        if params.double_integrator:
            vx = jax.random.uniform(kvx, (n,), minval=-params.v_max, maxval=params.v_max)
            vy = jax.random.uniform(kvy, (n,), minval=-params.v_max, maxval=params.v_max)
        else:
            vx = vy = jnp.zeros((n,))
        x = jnp.stack((px, py, vx, vy), axis=1)
        unobserved = jnp.ones((params.n_targets,), dtype=bool)
        # the reference's reset calls compute_helpers, which immediately
        # retires targets already inside someone's sensor radius
        # (old/mapping.py:112 -> :212) — no reward is granted for them
        values, network, obs_target, newly, _ = _mapping_helpers(x, unobserved, params)
        state = MappingState(
            time=jnp.int32(0),
            x=x,
            unobserved=unobserved & ~newly,
            last_obs_target=obs_target,
        )
        return state, (values, network)

    def _control(self, state: MappingState, action, params: MappingParams):
        u = jnp.clip(action, -params.max_accel, params.max_accel)
        return u * params.action_scalar

    def step_env(self, key, state: MappingState, action, params: MappingParams):
        u = self._control(state, action, params)
        x = state.x
        if params.parity_exact:
            from gym_flock_tpu.envs.flocking import _rnd
        else:
            _rnd = lambda t: t  # noqa: E731 - identity off the parity path
        if params.double_integrator:
            # Euler + velocity clipping (old/mapping.py:149-158)
            px = (
                x[:, 0]
                + _rnd(x[:, 2] * params.dt)
                + _rnd(u[:, 0] * params.dt * params.dt * 0.5)
            )
            py = (
                x[:, 1]
                + _rnd(x[:, 3] * params.dt)
                + _rnd(u[:, 1] * params.dt * params.dt * 0.5)
            )
            vx = jnp.clip(
                x[:, 2] + _rnd(u[:, 0] * params.dt), -params.v_max, params.v_max
            )
            vy = jnp.clip(
                x[:, 3] + _rnd(u[:, 1] * params.dt), -params.v_max, params.v_max
            )
        else:
            px = x[:, 0] + _rnd(u[:, 0] * params.dt)
            py = x[:, 1] + _rnd(u[:, 1] * params.dt)
            vx, vy = x[:, 2], x[:, 3]
        new_x = jnp.stack((px, py, vx, vy), axis=1)
        dist = jnp.sqrt(_rnd((px - x[:, 0]) ** 2) + _rnd((py - x[:, 1]) ** 2))  # [N]

        values, network, obs_target, newly, credit = _mapping_helpers(
            new_x, state.unobserved, params
        )
        new_unobserved = state.unobserved & ~newly
        if params.per_agent_reward:
            reward = credit - _rnd(params.dist_penalty * dist)  # [N]
        elif params.parity_exact:
            # reference order (old/mapping.py:161-165): integer observed
            # count, and the traveled-distance sum in NumPy's contiguous
            # 1-D pairwise accumulation order
            from gym_flock_tpu.envs.flocking import _np_pairwise_sum

            reward = _rnd(
                params.reward_scale * jnp.sum(newly)
            ) - _rnd(params.dist_penalty * _np_pairwise_sum(dist))
        else:
            reward = params.reward_scale * jnp.sum(newly) - params.dist_penalty * jnp.sum(dist)
        # all targets observed OR the registered step limit (the reference
        # relies on gym's TimeLimit wrapper, gym_flock/__init__.py:62-90;
        # every env family here applies its own limit — core/env.py)
        done = ~jnp.any(new_unobserved) | (state.time + 1 >= params.max_steps)
        new_state = state.replace(
            time=state.time + 1,
            x=new_x,
            unobserved=new_unobserved,
            last_obs_target=obs_target,
        )
        return new_state, (values, network), reward, done, {}

    def controller(self, state: MappingState, params: MappingParams):
        """Greedy: fly at the nearest unobserved target, as cached by the
        last observation pass (old/mapping.py:217, 224-232)."""
        if params.parity_exact:
            from gym_flock_tpu.envs.flocking import _opaque_div

            return _opaque_div(
                -1.0 * state.last_obs_target[:, 0:2], params.action_scalar
            )
        return -1.0 * state.last_obs_target[:, 0:2] / params.action_scalar

    def observation_space(self, params: MappingParams):
        d = (
            2 * params.observe_self_vel
            + params.neighbor_dims * params.nearest_agents * params.observe_neighbors
            + 2 * params.nearest_targets
        )
        return Box(-np.inf, np.inf, (params.n_agents, d))

    def action_space(self, params: MappingParams):
        return Box(-params.max_accel, params.max_accel, (params.n_agents, 2))


class MappingVelEnv(MappingEnv):
    """Velocity-controlled variant (reference old/mapping_vel.py:15-262):
    20 agents, 4-NN position-only neighbor obs, per-agent reward."""

    _px_tracks_n = True  # arena half-width follows n_agents (mapping_vel.py:63-64)

    def default_params(self) -> MappingParams:
        n = 20
        p = MappingParams(
            n_agents=n,
            nearest_agents=4,
            nearest_targets=4,
            double_integrator=False,
            neighbor_dims=2,
            per_agent_reward=True,
            zero_adj_diag=True,
            dt=0.1,
            action_scalar=1.0,
            obs_rad=1.0,
            px_max=float(n),
            py_max=float(n),
            dist_penalty=0.1,
            reward_scale=1.0,
        )
        return p.replace(target_x=jnp.asarray(make_target_grid(n, p.px_max, p.py_max)))


class MappingDiscEnv(MappingVelEnv):
    """Discrete-action variant (reference old/mapping_disc.py:15-270):
    the action selects one of the ``nearest_targets`` unobserved-target
    directions; the agent moves toward it at clipped velocity."""

    def default_params(self) -> MappingParams:
        p = super().default_params()
        return p.replace(dt=0.5, discrete_actions=True)

    def _control(self, state, action, params):
        # u indexes discrete_actions = hstack(-obs_target, zeros) cached by
        # the last observation pass (old/mapping_disc.py:132-133, 224)
        cand = -state.last_obs_target.reshape(
            (params.n_agents, params.nearest_targets, 2)
        )
        idx = jnp.asarray(action).reshape((params.n_agents,)).astype(jnp.int32)
        in_range = (idx >= 0) & (idx < params.nearest_targets)
        u = jnp.take_along_axis(
            cand, jnp.clip(idx, 0, params.nearest_targets - 1)[:, None, None], axis=1
        )[:, 0, :]
        u = jnp.where(in_range[:, None], u, 0.0)  # the appended zero action
        u = jnp.clip(u, -params.max_accel, params.max_accel)
        return u * params.action_scalar

    def controller(self, state, params):
        """The reference expert is unimplemented and returns zeros — i.e.
        'head for your nearest target' (old/mapping_disc.py:236-237)."""
        return jnp.zeros((params.n_agents, 1), dtype=jnp.int32)

    def action_space(self, params: MappingParams):
        # one choice PER AGENT (the reference declares a bare
        # Discrete(n_actions), old/mapping_disc.py, which its own step
        # cannot consume — here sample() must produce a steppable action)
        from gym_flock_tpu.core.spaces import MultiDiscrete

        return MultiDiscrete((params.nearest_targets,) * params.n_agents)


class MappingLocalEnv(MappingEnv):
    """Local-observation variant (reference old/mapping_local.py:15-272):
    double integrator, 4-NN, own velocity prepended, per-agent reward."""

    _px_tracks_n = True  # arena half-width follows n_agents (mapping_local.py:106-108)

    def default_params(self) -> MappingParams:
        n = 20
        p = MappingParams(
            n_agents=n,
            nearest_agents=4,
            nearest_targets=4,
            neighbor_dims=4,
            per_agent_reward=True,
            zero_adj_diag=True,
            observe_self_vel=True,
            dt=0.1,
            v_max=5.0,
            action_scalar=10.0,
            obs_rad=1.0,
            px_max=float(n),
            py_max=float(n),
            dist_penalty=0.1,
            reward_scale=1.0,
        )
        return p.replace(target_x=jnp.asarray(make_target_grid(n, p.px_max, p.py_max)))
