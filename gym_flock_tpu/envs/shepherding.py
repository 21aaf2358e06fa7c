"""Shepherding environment — unicycle herding with a line-of-sight expert.

Batched, jit-compiled re-design of reference gym_flock/envs/shepherding/shepherding.py:14-332:
10 shepherds herd 20 sheep into a goal disk at the origin.  Unicycle dynamics
with feedback linearization (offset d=0.3, reference :106-115); sheep are
repelled by shepherds (weight 0.45) and other sheep (weight 0.075) through
1/r^2 potentials truncated at r^2 > 2 (:164-178).  Reward is the fraction of
sheep inside the goal disk (:180-185).

The heuristic expert (:204-233) is a bang-bang policy on three line-of-sight
tests per shepherd (sheep within +-2 deg, other shepherd within +-2 deg, goal
within +-5 deg); the reference's Python loops become dense [S, M] angle-matrix
tests.  The reference's self-skip bug in ``_shepherd_in_los`` (:253-254 —
``s.all() == shepherd.all()`` skips *every* pair whose nonzero-ness matches,
not just self) is reproduced exactly for parity.
"""
from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from gym_flock_tpu.core import struct

from gym_flock_tpu.core.env import Env, EnvState
from gym_flock_tpu.core.spaces import Box

__all__ = ["ShepherdingParams", "ShepherdingState", "ShepherdingEnv", "shepherding_factory"]


@struct.dataclass
class ShepherdingParams:
    """Defaults mirror reference shepherding.py:16-70."""

    n_sheep: int = struct.field(pytree_node=False, default=20)
    n_shepherds: int = struct.field(pytree_node=False, default=10)
    max_steps: int = struct.field(pytree_node=False, default=1000)
    # bit-exact parity mode: mirror the reference's NumPy op order
    # (0 ULP at x64 for the whole step path; see the flocking family's
    # flocking_features_exact for the technique and the XLA rewrites the
    # barriers block).  The LoS expert is mirrored too, with one caveat:
    # XLA's and NumPy's arctan2 differ by 1 ULP on ~8% of inputs (cos/
    # sin/sqrt are identical — measured, test_other_envs_parity), so an
    # expert BRANCH decision could in principle flip at a state whose
    # bearing sits within 1 ULP of the 2/5-degree thresholds; the step
    # dynamics/obs/reward contain no arctan2 and are unconditionally
    # exact.
    parity_exact: bool = struct.field(pytree_node=False, default=False)

    dt: float = 0.01
    v_max: float = 2.0
    action_scalar: float = 5.0
    r_max_init: float = 1.0
    comm_radius: float = 2.0
    shepherd_weight: float = 0.15 * 3.0
    sheep_weight: float = 0.15 * 0.5
    d_offset: float = 0.3  # feedback-linearization offset (:107)
    wheel_base: float = 0.6  # differential-drive L (:224)

    @property
    def n_agents(self) -> int:
        return self.n_sheep + self.n_shepherds

    @property
    def r_max(self) -> float:
        return self.r_max_init * float(np.sqrt(self.n_agents))

    @property
    def goal_region_radius(self) -> float:
        return 0.5 * self.r_max

    @property
    def goal_offset(self) -> Tuple[float, float]:
        return (-self.r_max * 3.0, 0.0)


@struct.dataclass
class ShepherdingState(EnvState):
    x: jax.Array  # [n_agents, 3]: (px, py, theta); shepherds first


def _pairwise_r2(x: jax.Array, exact: bool = False):
    px, py = x[:, 0], x[:, 1]
    dx = px[:, None] - px[None, :]
    dy = py[:, None] - py[None, :]
    if exact:
        # parity mode: block fma contraction of dx*dx + dy*dy (NumPy
        # rounds each product; reference shepherding.py:136)
        from gym_flock_tpu.envs.flocking import _rnd

        r2 = _rnd(dx * dx) + _rnd(dy * dy)
    else:
        r2 = dx * dx + dy * dy
    return dx, dy, r2


class ShepherdingEnv(Env[ShepherdingParams, ShepherdingState]):
    def default_params(self) -> ShepherdingParams:
        return ShepherdingParams()

    # ------------------------------------------------------------- helpers

    def _sheep_controller(self, x: jax.Array, params: ShepherdingParams):
        """Repulsion velocities for sheep (reference :164-178)."""
        n = params.n_agents
        dx, dy, r2 = _pairwise_r2(x, exact=params.parity_exact)
        r2 = jnp.where(r2 > 2.0, jnp.inf, r2)
        r2 = jnp.where(jnp.eye(n, dtype=bool), jnp.inf, r2)
        w = jnp.concatenate(
            [
                jnp.full((params.n_shepherds,), params.shepherd_weight),
                jnp.full((params.n_sheep,), params.sheep_weight),
            ]
        )  # weight by source agent j (reference force_weights, :50)
        if params.parity_exact:
            # reference order (:174-177): w * (diff / r2), summed
            # sequentially in j (np.sum over the non-inner axis of the
            # dstacked [N, N, 2])
            from gym_flock_tpu.envs.flocking import _rnd, _seq_sum_cols

            rx = _seq_sum_cols(_rnd(w[None, :] * (dx / r2)))
            ry = _seq_sum_cols(_rnd(w[None, :] * (dy / r2)))
        else:
            rx = jnp.sum(w[None, :] * dx / r2, axis=1)
            ry = jnp.sum(w[None, :] * dy / r2, axis=1)
        return jnp.stack((rx, ry), axis=1)[params.n_shepherds :]

    def _adj_mat(self, x: jax.Array, params: ShepherdingParams):
        """Weighted 1/r adjacency (reference :139-162, defaults)."""
        n = params.n_agents
        _, _, r2 = _pairwise_r2(x, exact=params.parity_exact)
        r2 = jnp.where(jnp.eye(n, dtype=bool), jnp.inf, r2)
        adj = (r2 < params.comm_radius**2).astype(x.dtype)
        if params.parity_exact:
            # pin the real division: XLA may rewrite a / sqrt(b) into
            # a * rsqrt(b), which rounds differently from NumPy's
            # divide-by-sqrt
            from gym_flock_tpu.envs.flocking import _rnd

            return adj / _rnd(jnp.sqrt(r2))
        return adj / jnp.sqrt(r2)

    def _obs(self, state: ShepherdingState, params: ShepherdingParams):
        ident = jnp.concatenate(
            [jnp.ones((params.n_shepherds, 1)), jnp.zeros((params.n_sheep, 1))]
        )
        values = jnp.concatenate([state.x, ident], axis=1)  # [n, 4]
        return values, self._adj_mat(state.x, params)

    # ------------------------------------------------------------ protocol

    def reset_env(self, key: jax.Array, params: ShepherdingParams):
        """Disk initialization around the goal offset (reference :187-202)."""
        n = params.n_agents
        k1, k2 = jax.random.split(key)
        length = jnp.sqrt(jax.random.uniform(k1, (n,), minval=0.0, maxval=params.r_max))
        angle = jnp.pi * jax.random.uniform(k2, (n,), minval=0.0, maxval=2.0)
        gx, gy = params.goal_offset
        x = jnp.stack(
            (
                length * jnp.cos(angle) + gx,
                length * jnp.sin(angle) + gy,
                jnp.zeros((n,)),
            ),
            axis=1,
        )
        state = ShepherdingState(time=jnp.int32(0), x=x)
        return state, self._obs(state, params)

    def init_state(self, x, params: ShepherdingParams) -> ShepherdingState:
        return ShepherdingState(time=jnp.int32(0), x=jnp.asarray(x))

    def step_env(self, key, state: ShepherdingState, action, params: ShepherdingParams):
        """Unicycle update via feedback linearization (reference :80-117)."""
        S = params.n_shepherds
        x = state.x
        u = jnp.concatenate(
            [action * params.action_scalar, self._sheep_controller(x, params)], axis=0
        )
        theta = x[:, 2]
        d = params.d_offset
        if params.parity_exact:
            from gym_flock_tpu.envs.flocking import _opaque_div, _rnd

            ct, st = jnp.cos(theta), jnp.sin(theta)
            v = _rnd(u[:, 0] * ct) + _rnd(u[:, 1] * st)
            w = _rnd(u[:, 0] * _opaque_div(-st, d)) + _rnd(
                u[:, 1] * _opaque_div(ct, d)
            )
            v = v.at[S:].set(v[S:] / 2.0 + 0.5)
            px = x[:, 0] + _rnd(v * ct * params.dt)
            py = x[:, 1] + _rnd(v * st * params.dt)
            th = theta + _rnd(w * params.dt)
        else:
            v = u[:, 0] * jnp.cos(theta) + u[:, 1] * jnp.sin(theta)
            w = u[:, 0] * (-jnp.sin(theta) / d) + u[:, 1] * (jnp.cos(theta) / d)
            # sheep move with constant forward bias (reference :110)
            v = v.at[S:].set(v[S:] / 2.0 + 0.5)

            px = x[:, 0] + v * jnp.cos(theta) * params.dt
            py = x[:, 1] + v * jnp.sin(theta) * params.dt
            th = theta + w * params.dt
        new_x = jnp.stack((px, py, th), axis=1)

        new_state = state.replace(x=new_x, time=state.time + 1)
        reward = self._instant_cost(new_x, params)
        done = new_state.time >= params.max_steps
        return new_state, self._obs(new_state, params), reward, done, {}

    def _instant_cost(self, x, params):
        """Fraction of sheep in the goal disk (reference :180-185)."""
        sheep = x[params.n_shepherds :, 0:2]
        if params.parity_exact:
            from gym_flock_tpu.envs.flocking import _opaque_div, _rnd

            sx, sy = sheep[:, 0], sheep[:, 1]
            nrm = jnp.sqrt(_rnd(sx * sx) + _rnd(sy * sy))
            inside = nrm < params.goal_region_radius
            return _opaque_div(
                jnp.sum(inside).astype(x.dtype), params.n_sheep
            )
        inside = jnp.linalg.norm(sheep, axis=1) < params.goal_region_radius
        return jnp.sum(inside) / params.n_sheep

    # ----------------------------------------------------------- controller

    def controller(self, state: ShepherdingState, params: ShepherdingParams):
        """Vectorized line-of-sight bang-bang expert (reference :204-233).

        Priority: sheep in LoS (+-2 deg) > other shepherd in LoS (+-2 deg,
        including the reference's nonzero-ness self-skip bug) > goal in LoS
        (+-5 deg) > default arc.
        """
        S = params.n_shepherds
        x = state.x
        sx = x[:S]  # shepherds [S, 3]
        theta = sx[:, 2]

        def wrap(a):
            # reference _wrapToPi returns 0.0 for exactly-zero input (:236-238)
            return jnp.where(a == 0.0, 0.0, jnp.arctan2(jnp.sin(a), jnp.cos(a)))

        def in_los(targets, tol):
            # [S, M] test of |wrap(bearing - heading)| < tol
            dx = targets[None, :, 0] - sx[:, None, 0]
            dy = targets[None, :, 1] - sx[:, None, 1]
            th = jnp.arctan2(dy, dx)
            return jnp.abs(wrap(th - theta[:, None])) < tol

        deg2 = jnp.deg2rad(2.0)
        sheep_los = jnp.any(in_los(x[S:], deg2), axis=1)

        # reference skip condition: continue iff s.all() == shepherd.all()
        # (truthiness of "all coordinates nonzero", shepherding.py:253-254)
        all_nz = jnp.all(sx != 0.0, axis=1)  # [S]
        pair_skip = all_nz[:, None] == all_nz[None, :]
        shep_los = jnp.any(in_los(sx, deg2) & ~pair_skip, axis=1)

        goal = jnp.zeros((1, 2))
        goal_los = in_los(goal, jnp.deg2rad(5.0))[:, 0]

        vlr_sheep = jnp.asarray([0.0082, 0.9996])
        vlr_shep = jnp.asarray([0.5471, 0.6098])
        vlr_goal = jnp.asarray([0.9993, 0.9447])
        vlr_none = jnp.asarray([0.9998, 0.8520])

        vlr = jnp.where(
            sheep_los[:, None],
            vlr_sheep,
            jnp.where(shep_los[:, None], vlr_shep, jnp.where(goal_los[:, None], vlr_goal, vlr_none)),
        )

        L, d = params.wheel_base, params.d_offset
        v = (vlr[:, 1] + vlr[:, 0]) / 2.0
        if params.parity_exact:
            from gym_flock_tpu.envs.flocking import _opaque_div, _rnd

            w = _opaque_div(vlr[:, 1] - vlr[:, 0], L)
            ct, st = jnp.cos(theta), jnp.sin(theta)
            vx = _rnd(v * ct) - _rnd(w * d * st)
            vy = _rnd(v * st) + _rnd(w * d * ct)
        else:
            w = (vlr[:, 1] - vlr[:, 0]) / L
            vx = v * jnp.cos(theta) - w * d * jnp.sin(theta)
            vy = v * jnp.sin(theta) + w * d * jnp.cos(theta)
        return jnp.stack((vx, vy), axis=1)

    # ---------------------------------------------------------------- spaces

    def observation_space(self, params):
        # 4 features: [x, y, theta, shepherd/sheep identity].  The
        # reference DECLARES nx=3 but its _compute_observations hstacks the
        # identity column (shepherding.py) — the declaration is the bug;
        # this space describes the actual obs so buffer-sizing consumers
        # work
        return Box(-jnp.inf, jnp.inf, (params.n_agents, 4))

    def action_space(self, params):
        return Box(-params.v_max, params.v_max, (params.n_shepherds, 2))


def shepherding_factory(**kwargs):
    env = ShepherdingEnv()
    params = env.default_params()
    if kwargs:
        params = params.replace(**kwargs)
    return env, params
