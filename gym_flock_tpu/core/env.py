"""Pure-functional environment protocol — the core API.

The reference (katetolstaya/gym-flock) exposes stateful gym 0.11 objects with
``reset()/step()/render()/seed()`` plus the non-standard ``controller()``
expert (reference README.md:25-30).  That design is host-Python-centric: one
mutable NumPy object per environment instance, stepped one at a time.

This design inverts it: an :class:`Env` is a *namespace of pure
functions* over an immutable pytree ``State`` and a static pytree ``Params``:

    state, obs      = env.reset(key, params)
    state, obs, r, done, info = env.step(key, state, action, params)
    action          = env.controller(state, params)     # the expert policy

Because every function is pure and shapes are static, the whole step —
dynamics, graph construction, observation assembly, reward — jits into a
single XLA program, batches with ``jax.vmap`` over thousands of env
instances, and shards over a device mesh with ``jax.sharding`` (see
``gym_flock_tpu.parallel``).  The gym-flock class API is reconstructed on top
in ``gym_flock_tpu.compat`` for drop-in use.

Conventions
-----------
* ``reset(key, params)`` consumes a ``jax.random`` key; there is no hidden
  RNG state (reference envs mix a seeded ``np_random`` with the *global*
  ``np.random`` stream — flocking_relative.py:167-174 vs :87-89 — a hazard
  this API removes by construction).
* ``step`` takes a key so stochastic envs (FlockingStochastic's random dt,
  LQR process noise) stay pure.
* ``done`` is a bool scalar; episode truncation (gym's ``max_episode_steps``)
  lives in ``params.max_steps`` and is applied by the env itself or by
  :func:`gym_flock_tpu.parallel.rollout`.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, Generic, Optional, Tuple, TypeVar

import jax
import jax.numpy as jnp
from gym_flock_tpu.core import struct

from gym_flock_tpu.core.spaces import Space

TParams = TypeVar("TParams")
TState = TypeVar("TState")
Obs = Any
Action = Any

__all__ = ["Env", "EnvState", "EnvTransition", "step_autoreset"]


@struct.dataclass
class EnvState:
    """Base for env states: every state carries the step counter."""

    time: jax.Array  # int32 scalar, steps since reset


@struct.dataclass
class EnvTransition:
    """One (s, a, r, s') record emitted by rollout engines."""

    obs: Any
    action: Any
    reward: jax.Array
    done: jax.Array
    info: Dict[str, Any]


class Env(Generic[TParams, TState]):
    """Abstract pure-functional environment.

    Subclasses implement ``reset_env`` / ``step_env`` / spaces, and get
    jitted, auto-reset-capable ``reset`` / ``step`` entry points for free.
    """

    # ------------------------------------------------------------------ API

    def default_params(self) -> TParams:
        raise NotImplementedError

    def reset_env(self, key: jax.Array, params: TParams) -> Tuple[TState, Obs]:
        raise NotImplementedError

    def step_env(
        self, key: jax.Array, state: TState, action: Action, params: TParams
    ) -> Tuple[TState, Obs, jax.Array, jax.Array, Dict[str, Any]]:
        raise NotImplementedError

    def controller(self, state: TState, params: TParams) -> Action:
        """Expert action (reference ``env.controller()``, README.md:25-26)."""
        raise NotImplementedError

    def observation_space(self, params: TParams) -> Space:
        raise NotImplementedError

    def action_space(self, params: TParams) -> Space:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    # Envs are stateless function namespaces: hash/eq by type so every
    # instance shares one jit cache (``reset``/``step``/``expert`` use
    # ``static_argnums=(0,)``; identity hashing would recompile per instance).
    def __hash__(self):
        return hash(type(self))

    def __eq__(self, other):
        return type(self) is type(other)

    # ------------------------------------------------------- jitted wrappers

    @partial(jax.jit, static_argnums=(0,))
    def reset(self, key: jax.Array, params: TParams) -> Tuple[TState, Obs]:
        return self.reset_env(key, params)

    @partial(jax.jit, static_argnums=(0,))
    def step(
        self, key: jax.Array, state: TState, action: Action, params: TParams
    ) -> Tuple[TState, Obs, jax.Array, jax.Array, Dict[str, Any]]:
        return self.step_env(key, state, action, params)

    @partial(jax.jit, static_argnums=(0,))
    def expert(self, state: TState, params: TParams) -> Action:
        """Jitted expert action (``controller`` with default options).

        Eager per-op dispatch costs a device launch per operation; use this
        (or your own jit of ``controller``) on the hot path.
        """
        return self.controller(state, params)


def step_autoreset(
    env: Env, key: jax.Array, state: TState, action: Action, params: TParams
):
    """Step and, where ``done``, replace the state with a fresh reset.

    This is the batched-rollout workhorse: under ``vmap`` each env instance
    resets independently the step it terminates, so device utilisation never
    drops while other instances continue.  The terminal observation is
    returned in ``info['terminal_obs']``; ``obs`` is the post-reset
    observation when ``done`` (the standard auto-reset convention).
    """
    key_step, key_reset = jax.random.split(key)
    st, obs_step, reward, done, info = env.step_env(key_step, state, action, params)
    st_reset, obs_reset = env.reset_env(key_reset, params)

    # `done` is a scalar bool per (unbatched) env instance; under vmap each
    # instance selects independently.  Scalar-cond jnp.where broadcasts.
    new_state = jax.tree.map(lambda a, b: jnp.where(done, b, a), st, st_reset)
    new_obs = jax.tree.map(lambda a, b: jnp.where(done, b, a), obs_step, obs_reset)
    info = dict(info)
    info["terminal_obs"] = obs_step
    return new_state, new_obs, reward, done, info
