"""Delayed K-hop aggregation flocking — pure-JAX FlockingMultiEnv.

Batched, jit-compiled re-design of the reference's ``old/flocking_multi.py:16-300``
(SURVEY.md §2.2 #22): the environment itself maintains the multi-hop
aggregated observation of Tolstaya et al.'s delayed-aggregation GNN — each
step, every agent receives the mean of its neighbors' PREVIOUS aggregation
buffer, shifted one filter tap, so information diffuses one hop per
timestep:

    agg_t = [features(x_t) | mean_{j in N(i)} agg_{t-1}[j, :-nx]]

State layout: ``x_agg`` is ``[N, nx * filter_len]`` (the reference carries a
trailing pooling axis, old/flocking_multi.py:52; only nanmean pooling is
active upstream — :38 — so it is a singleton and elided here; additional
pooling modes live in ``gym_flock_tpu.models``/``ops.khop_aggregate``).

The masked-mean pooling replaces the reference's NaN-poisoning trick
(``a_net[a_net == 0] = np.nan`` then ``np.nanmean``,
old/flocking_multi.py:238-263): a degree-normalized masked matmul is
mathematically identical (isolated agents pool to zero) and is one matrix
product instead of an [N, N, F] NaN tensor.

NOTE: upstream this class is dead code that cannot even be constructed —
it reads ``old/params_flock.cfg`` which does not exist
(old/flocking_multi.py:20-23 raises KeyError).  Defaults here follow the
live config ``flocking/params_flock.cfg`` the file was written against.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from gym_flock_tpu.core import struct

from gym_flock_tpu.core.env import Env, EnvState
from gym_flock_tpu.core.spaces import Box

__all__ = ["FlockingMultiParams", "FlockingMultiState", "FlockingMultiEnv"]


@struct.dataclass
class FlockingMultiParams:
    """Defaults per flocking/params_flock.cfg (filter_length=3, N_features=18,
    network_size=80, comm_radius=0.9, system_dt=0.01, max_vel_init=3.0,
    max_rad_init=10.0, std_dev=0.1*dt)."""

    # --- static ---
    n_agents: int = struct.field(pytree_node=False, default=80)
    filter_len: int = struct.field(pytree_node=False, default=3)
    nx: int = struct.field(pytree_node=False, default=6)  # (x, init_vel)
    max_steps: int = struct.field(pytree_node=False, default=1000)
    max_reset_tries: int = struct.field(pytree_node=False, default=64)

    # --- dynamic ---
    comm_radius: float = 0.9
    dt: float = 0.01
    v_max: float = 3.0
    r_max: float = 10.0
    std_dev: float = 0.1 * 0.01  # cfg std_dev * dt (old/flocking_multi.py:36)
    max_accel: float = 40.0
    max_z: float = 200.0
    accel_gain: float = 0.1  # the "0.1 * u" in the dynamics (:106-109)

    @property
    def n_features(self) -> int:
        return self.nx * self.filter_len

    @property
    def comm_radius2(self) -> float:
        return self.comm_radius * self.comm_radius


@struct.dataclass
class FlockingMultiState(EnvState):
    x: jax.Array  # [N, 4]
    x_agg: jax.Array  # [N, nx * filter_len]
    init_vel: jax.Array  # [N, 2]
    mean_vel: jax.Array  # [2]


def _aggregate(x: jax.Array, x_agg: jax.Array, init_vel: jax.Array, params):
    """One diffusion tap (reference aggregate/get_comms/get_pool,
    old/flocking_multi.py:182-263)."""
    n, nx = params.n_agents, params.nx
    feats = jnp.concatenate((x, init_vel), axis=1)  # [N, nx]

    pos = x[:, 0:2]
    d2 = jnp.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=2)
    adj = (d2 < params.comm_radius2).astype(x.dtype) * (1.0 - jnp.eye(n, dtype=x.dtype))

    prev = x_agg[:, : nx * (params.filter_len - 1)]  # drop the oldest tap
    deg = jnp.sum(adj, axis=0)  # in-degree of each receiver j
    # full float32 (not TF32 on a GPU): the aggregation is the environment's
    # observation, not a model product
    pooled = jnp.matmul(adj.T, prev, precision=jax.lax.Precision.HIGHEST)
    pooled = pooled / jnp.maximum(deg, 1.0)[:, None]
    pooled = jnp.where(deg[:, None] > 0, pooled, 0.0)  # nanmean-of-empty -> 0
    return jnp.concatenate((feats, pooled), axis=1)


class FlockingMultiEnv(Env[FlockingMultiParams, FlockingMultiState]):
    """Noisy double-integrator flock whose observation is the in-env
    delayed K-hop aggregation buffer, clipped to ±max_z and flattened
    (reference old/flocking_multi.py:95-135)."""

    def default_params(self) -> FlockingMultiParams:
        return FlockingMultiParams()

    def _obs(self, state: FlockingMultiState, params):
        clipped = jnp.clip(state.x_agg, -params.max_z, params.max_z)
        return clipped.reshape(-1)

    def reset_env(self, key: jax.Array, params: FlockingMultiParams):
        """Rejection-sampling disk reset, degree >= 2 and min dist >= 0.1
        (old/flocking_multi.py:136-177), bounded trips."""
        n = params.n_agents

        def draw(key):
            k1, k2, k3, k4, k5 = jax.random.split(key, 5)
            length = jnp.sqrt(jax.random.uniform(k1, (n,), minval=0.0, maxval=params.r_max))
            angle = jnp.pi * jax.random.uniform(k2, (n,), minval=0.0, maxval=2.0)
            bias = jax.random.uniform(k3, (2,), minval=-params.v_max, maxval=params.v_max)
            vx = jax.random.uniform(k4, (n,), minval=-params.v_max, maxval=params.v_max)
            vy = jax.random.uniform(k5, (n,), minval=-params.v_max, maxval=params.v_max)
            return jnp.stack(
                (length * jnp.cos(angle), length * jnp.sin(angle), vx + bias[0], vy + bias[1]),
                axis=1,
            )

        def accept(x):
            pos = x[:, 0:2]
            d2 = jnp.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=2)
            d2 = d2 + jnp.where(jnp.eye(n, dtype=bool), jnp.inf, 0.0)
            degree = jnp.min(jnp.sum(d2 < params.comm_radius2, axis=1))
            return (degree >= 2) & (jnp.sqrt(jnp.min(d2)) >= 0.1)

        def cond(c):
            _, _, ok, tries = c
            return (~ok) & (tries < params.max_reset_tries)

        def body(c):
            key, _, _, tries = c
            key, sub = jax.random.split(key)
            x = draw(sub)
            return key, x, accept(x), tries + 1

        key0, sub0 = jax.random.split(key)
        x0 = draw(sub0)
        _, x, _, _ = jax.lax.while_loop(cond, body, (key0, x0, accept(x0), jnp.int32(1)))

        init_vel = x[:, 2:4]
        agg0 = jnp.zeros((n, params.n_features))
        x_agg = _aggregate(x, agg0, init_vel, params)
        state = FlockingMultiState(
            time=jnp.int32(0),
            x=x,
            x_agg=x_agg,
            init_vel=init_vel,
            mean_vel=jnp.mean(init_vel, axis=0),
        )
        return state, self._obs(state, params)

    def step_env(self, key, state: FlockingMultiState, action, params):
        u = jnp.reshape(action, (-1, 2))
        noise = params.std_dev * jax.random.normal(key, (params.n_agents, 2))
        x = state.x
        px = x[:, 0] + x[:, 2] * params.dt
        py = x[:, 1] + x[:, 3] * params.dt
        vx = x[:, 2] + params.accel_gain * u[:, 0] * params.dt + noise[:, 0]
        vy = x[:, 3] + params.accel_gain * u[:, 1] * params.dt + noise[:, 1]
        new_x = jnp.stack((px, py, vx, vy), axis=1)

        x_agg = _aggregate(new_x, state.x_agg, state.init_vel, params)
        new_state = state.replace(time=state.time + 1, x=new_x, x_agg=x_agg)
        # reward = -sum ||v - mean_vel(init)||^2 (old/flocking_multi.py:118-121);
        # upstream never terminates (:116)
        reward = -jnp.sum(jnp.square(new_x[:, 2:4] - state.mean_vel[None, :]))
        done = new_state.time >= params.max_steps
        return new_state, self._obs(new_state, params), reward, done, {}

    def controller(self, state: FlockingMultiState, params):
        """Consensus expert: u = 10 * (mean_v - v), clipped
        (old/flocking_multi.py:271-279)."""
        mean_v = jnp.mean(state.x[:, 2:4], axis=0)
        u = 10.0 * (mean_v[None, :] - state.x[:, 2:4])
        return jnp.clip(u, -params.max_accel, params.max_accel)

    def observation_space(self, params):
        return Box(-params.max_z, params.max_z, (params.n_agents * params.n_features,))

    def action_space(self, params):
        return Box(-params.max_accel, params.max_accel, (params.n_agents, 2))
