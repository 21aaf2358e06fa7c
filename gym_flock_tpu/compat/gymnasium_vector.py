"""Gymnasium ``VectorEnv``-style facade over the BATCHED device path.

The single-env facades (``gym_api`` / ``gymnasium_api``) wrap the
single-stream legacy pipeline; this module is the entry point standard RL
libraries actually want: a synchronous vector env whose whole batch steps
as ONE jitted XLA program (``vmap`` over the env axis — the same engine as
``parallel.batch_rollout``), with NumPy in/out::

    venv = make_gymnasium_vector("FlockingRelative-v0", num_envs=1024)
    obs, infos = venv.reset(seed=0)
    u = venv.controller()                      # batched expert [B, ...]
    obs, rew, term, trunc, infos = venv.step(u)

Like the sibling facades it does NOT import the ``gymnasium`` package —
the surface is duck-typed to ``gymnasium.vector.VectorEnv`` with
SAME-STEP autoreset (the classic ``SyncVectorEnv`` convention, equal to
``AutoresetMode.SAME_STEP`` in gymnasium 1.x): when an episode ends, the
returned ``obs`` row is already the post-reset observation, and the final
observation of the finished episode is delivered in
``infos["final_observation"]`` (object array) masked by
``infos["_final_observation"]``.

Terminated/truncated use the per-family split documented in
``gymnasium_api`` (time-driven / mixed / terminal) — the reference's
single ``done`` flag cannot be surfaced as ``terminated`` wholesale
without corrupting value bootstrapping.

Throughput note: each ``step`` is one device program plus one
device->host transfer of the batched obs, so the rate is bounded by the
host round trip, not the kernels.  For training loops that can stay on device entirely,
``parallel.batch_rollout`` / ``batch_expert_rollout`` remain the right
(scan-fused) path — this facade exists for NumPy-API consumers
(CleanRL-style loops, evaluation harnesses).
"""
from __future__ import annotations


from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gym_flock_tpu.compat.gymnasium_api import _done_semantics
from gym_flock_tpu.core.registry import make as _make
from gym_flock_tpu.core.registry import registry as _registry
from gym_flock_tpu.core.spaces import Box, DictSpace, Discrete, MultiDiscrete

__all__ = ["GymnasiumVectorEnv", "make_gymnasium_vector", "batch_space"]


def batch_space(space, n: int):
    """Prepend the batch axis to a single-env space (gymnasium's
    ``batch_space`` analog for the internal space types)."""
    if isinstance(space, Box):
        return Box(space.low, space.high, (n,) + tuple(space.shape), space.dtype)
    if isinstance(space, Discrete):
        return MultiDiscrete((space.n,) * n)
    if isinstance(space, MultiDiscrete):
        # keep MultiDiscrete semantics (integer sampling, exact per-dim
        # containment): the batch flattens to [n * len(nvec)] with the
        # per-dim cardinalities tiled — reshape samples to [n, len(nvec)]
        return MultiDiscrete(tuple(space.nvec) * n)
    if isinstance(space, DictSpace):
        return DictSpace({k: batch_space(v, n) for k, v in space.spaces.items()})
    raise TypeError(f"cannot batch space {space!r}")


class GymnasiumVectorEnv:
    """Synchronous vector env: one jitted program per ``step``/``reset``."""

    def __init__(
        self,
        env_id: str,
        num_envs: int,
        max_episode_steps: Optional[int] = None,
        **kwargs,
    ):
        self.env_id = env_id
        self.num_envs = int(num_envs)
        self._env, self._params = _make(env_id, **kwargs)
        spec = _registry.get(env_id)
        if max_episode_steps is None and spec is not None:
            max_episode_steps = spec.max_episode_steps
        if max_episode_steps == 0:
            # same convention as make_gymnasium: 0 disables the limit
            max_episode_steps = None
        self.max_episode_steps = max_episode_steps
        self._done_kind = _done_semantics(env_id)
        self._state = None
        self._elapsed = None  # [B] int32 on device
        self._key = None
        self._ctrl_cache: Dict[tuple, Any] = {}

        env, params = self._env, self._params
        limit = self.max_episode_steps
        kind = self._done_kind
        env_max = getattr(params, "max_steps", None)

        @jax.jit
        def _vreset(key):
            keys = jax.random.split(key, self.num_envs)
            states, obs = jax.vmap(lambda k: env.reset_env(k, params))(keys)
            return states, obs

        @jax.jit
        def _vstep(key, states, actions, elapsed):
            keys = jax.random.split(key, self.num_envs)

            def one(k, s, a, el):
                k_step, k_reset = jax.random.split(k)
                s2, obs, r, done, _ = env.step_env(k_step, s, a, params)
                el2 = el + 1
                limit_hit = (
                    el2 >= limit if limit is not None else jnp.bool_(False)
                )
                if kind == "time":
                    term = jnp.bool_(False)
                    trunc = done | limit_hit
                elif kind == "mixed":
                    time_hit = (
                        el2 >= int(env_max)
                        if env_max is not None
                        else jnp.bool_(False)
                    )
                    term = done & ~time_hit
                    trunc = (done & time_hit) | limit_hit
                else:  # "terminal"
                    term = done
                    trunc = limit_hit
                finish = term | trunc
                s_r, obs_r = env.reset_env(k_reset, params)
                s3 = jax.tree.map(lambda x, y: jnp.where(finish, y, x), s2, s_r)
                obs3 = jax.tree.map(
                    lambda x, y: jnp.where(finish, y, x), obs, obs_r
                )
                return s3, obs3, r, term, trunc, finish, obs

            return jax.vmap(one)(keys, states, actions, elapsed)

        self._vreset = _vreset
        self._vstep = _vstep

    # -- gymnasium.vector surface ------------------------------------------

    @property
    def single_observation_space(self):
        return self._env.observation_space(self._params)

    @property
    def single_action_space(self):
        return self._env.action_space(self._params)

    @property
    def observation_space(self):
        return batch_space(self.single_observation_space, self.num_envs)

    @property
    def action_space(self):
        return batch_space(self.single_action_space, self.num_envs)

    @property
    def params(self):
        return self._params

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[Dict] = None
    ) -> Tuple[Any, Dict]:
        if seed is not None:
            self._key = jax.random.key(seed)
        elif self._key is None:
            # never seeded: fresh OS entropy (gymnasium's unseeded default)
            # — but an unseeded reset AFTER a seeded one must CONTINUE the
            # stream, or two identically-seeded runs diverge there
            self._key = jax.random.key(
                int(np.random.SeedSequence().entropy) & 0x7FFFFFFF
            )
        self._key, sub = jax.random.split(self._key)
        self._state, obs = self._vreset(sub)
        self._elapsed = jnp.zeros((self.num_envs,), jnp.int32)
        return jax.tree.map(np.asarray, obs), {}

    def step(self, actions) -> Tuple[Any, np.ndarray, np.ndarray, np.ndarray, Dict]:
        assert self._state is not None, "call reset() first"
        actions = jax.tree.map(jnp.asarray, actions)
        self._key, sub = jax.random.split(self._key)
        (
            self._state,
            obs,
            reward,
            term,
            trunc,
            finish,
            final_obs,
        ) = self._vstep(sub, self._state, actions, self._elapsed)
        self._elapsed = jnp.where(finish, 0, self._elapsed + 1)
        term = np.asarray(term)
        trunc = np.asarray(trunc)
        infos: Dict[str, Any] = {}
        mask = term | trunc
        if mask.any():
            fo = jax.tree.map(np.asarray, final_obs)
            arr = np.full((self.num_envs,), None, dtype=object)
            fi = np.full((self.num_envs,), None, dtype=object)
            for i in np.nonzero(mask)[0]:
                arr[i] = jax.tree.map(lambda x: x[i], fo)
                fi[i] = {}  # these envs emit no per-step info payload
            infos["final_observation"] = arr
            infos["_final_observation"] = mask
            infos["final_info"] = fi
            infos["_final_info"] = mask
        return (
            jax.tree.map(np.asarray, obs),
            np.asarray(reward),
            term,
            trunc,
            infos,
        )

    def controller(self, **kwargs):
        """Batched expert actions for the CURRENT states [B, ...] — the
        reference's non-standard surface, vectorized.  kwargs forward to
        the env's controller (``greedy=False`` is NOT supported here — the
        VRP expert is host-side; see experts.coverage_vrp).  Controllers
        that accept a ``key`` (e.g. coverage's unreachable-target random
        fallback) get an independent per-env key."""
        assert self._state is not None, "call reset() first"
        cache_key = tuple(sorted(kwargs.items()))
        fn = self._ctrl_cache.get(cache_key)
        if fn is None:
            env, params = self._env, self._params
            import inspect

            takes_key = "key" in inspect.signature(env.controller).parameters

            @jax.jit
            def fn(states, key):
                keys = jax.random.split(key, self.num_envs)

                def one(s, k):
                    if takes_key:
                        return env.controller(s, params, key=k, **kwargs)
                    return env.controller(s, params, **kwargs)

                return jax.vmap(one)(states, keys)

            self._ctrl_cache[cache_key] = fn
        self._key, sub = jax.random.split(self._key)
        return np.asarray(fn(self._state, sub))

    def render(self):  # pragma: no cover - no batched rendering
        raise NotImplementedError(
            "vector envs don't render; use make_gymnasium() for a single "
            "rendering env"
        )

    def close(self):
        self._state = None

    def __repr__(self):
        return (
            f"GymnasiumVectorEnv({self.env_id!r}, num_envs={self.num_envs})"
        )


def make_gymnasium_vector(
    env_id: str, num_envs: int = 64, **kwargs
) -> GymnasiumVectorEnv:
    """``gymnasium.make_vec``-style construction (see class docstring)."""
    return GymnasiumVectorEnv(env_id, num_envs, **kwargs)
