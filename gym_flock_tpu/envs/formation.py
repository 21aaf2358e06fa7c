"""Formation flying — 3-agent single-integrator goal seeking.

Batched, jit-compiled re-design of reference gym_flock/envs/formation/formation_flying.py:18-213
(config values inlined from formation/formation_flying.cfg): agents start at
fixed points on the x-axis and must reach a fixed goal triangle; reward is
the negative sum of squared distances to goals (:81-90); connectivity is a
degree-1 nearest-neighbor graph on the *goal* coordinates (:160-177 fits
sklearn NearestNeighbors on ``x[:, 2:4]``), here a plain top-k.

The reference has no ``controller``; a proportional go-to-goal expert is
provided as the natural imitation target (clearly marked as an extension).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from gym_flock_tpu.core import struct

from gym_flock_tpu.core.env import Env, EnvState
from gym_flock_tpu.core.spaces import Box

__all__ = ["FormationParams", "FormationState", "FormationFlyingEnv", "formation_factory"]


@struct.dataclass
class FormationParams:
    """Values from formation_flying.cfg + formation_flying.py:27-55."""

    n_agents: int = struct.field(pytree_node=False, default=3)
    max_steps: int = struct.field(pytree_node=False, default=500)
    degree: int = struct.field(pytree_node=False, default=1)  # kNN degree (:30)
    mean_pooling: bool = struct.field(pytree_node=False, default=False)
    dynamic: bool = struct.field(pytree_node=False, default=True)

    comm_radius: float = 2.0  # cfg comm_radius
    dt: float = 0.01  # cfg system_dt (step uses a hardcoded 0.1 gain, :75-77)
    v_max: float = 2.0  # cfg max_vel_init
    r_max: float = 6.0  # cfg max_rad_init
    max_accel: float = 1.0
    step_gain: float = 0.1  # the literal 0.1 in reference step (:75-77)


@struct.dataclass
class FormationState(EnvState):
    x: jax.Array  # [n, 4]: (px, py, goal_x, goal_y)


# plain tuples: converted at trace time so they follow the active x64 mode
_START_X = (0.0, -2.0, 2.0)
_START_Y = (0.0, 0.0, 0.0)
_GOAL_X = (0.0, -2.0, 2.0)
_GOAL_Y = (2.0, 2.0, 2.0)


class FormationFlyingEnv(Env[FormationParams, FormationState]):
    def default_params(self) -> FormationParams:
        return FormationParams()

    def _connectivity(self, x: jax.Array, params: FormationParams):
        """Degree-k nearest neighbors on goal coords (reference :160-177)."""
        g = x[:, 2:4]
        dx = g[:, None, :] - g[None, :, :]
        r2 = jnp.sum(dx * dx, axis=-1)
        n = params.n_agents
        r2 = jnp.where(jnp.eye(n, dtype=bool), jnp.inf, r2)
        _, idx = jax.lax.top_k(-r2, params.degree)
        a = jnp.zeros((n, n))
        a = a.at[jnp.arange(n)[:, None], idx].set(1.0)
        if params.mean_pooling:
            deg = jnp.sum(a, axis=1, keepdims=True)
            a = a / jnp.where(deg == 0, 1.0, deg)
        return a

    def _obs(self, state: FormationState, params: FormationParams):
        # reference _get_obs returns state_values only (:141-150)
        return state.x

    def reset_env(self, key, params: FormationParams):
        x = jnp.stack(
            tuple(jnp.asarray(c) for c in (_START_X, _START_Y, _GOAL_X, _GOAL_Y)),
            axis=1,
        )
        state = FormationState(time=jnp.int32(0), x=x)
        return state, self._obs(state, params)

    def step_env(self, key, state: FormationState, action, params: FormationParams):
        u = jnp.reshape(action, (params.n_agents, 2))
        x = state.x
        x = x.at[:, 0].add(u[:, 0] * params.step_gain)
        x = x.at[:, 1].add(u[:, 1] * params.step_gain)
        new_state = state.replace(x=x, time=state.time + 1)
        reward = self._instant_cost(x)
        done = new_state.time >= params.max_steps
        return new_state, self._obs(new_state, params), reward, done, {}

    def _instant_cost(self, x):
        diff = (x[:, 0] - x[:, 2]) ** 2 + (x[:, 1] - x[:, 3]) ** 2
        return -jnp.sum(diff)

    def connectivity(self, state: FormationState, params: FormationParams):
        """Public accessor mirroring reference ``get_connectivity`` (:160)."""
        return self._connectivity(state.x, params)

    def controller(self, state: FormationState, params: FormationParams):
        """Proportional go-to-goal expert (extension; reference has none)."""
        err = state.x[:, 2:4] - state.x[:, 0:2]
        return jnp.clip(err, -params.max_accel, params.max_accel)

    def observation_space(self, params):
        return Box(-jnp.inf, jnp.inf, (params.n_agents, 4))

    def action_space(self, params):
        return Box(-params.max_accel, params.max_accel, (2 * params.n_agents,))


def formation_factory(**kwargs):
    env = FormationFlyingEnv()
    params = env.default_params()
    if kwargs:
        params = params.replace(**kwargs)
    return env, params
