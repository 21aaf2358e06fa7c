"""Rollout engines: jit/scan episode loops, vmapped batches, sharded fleets.

The reference steps one env at a time from Python (reference test.py:43-70).
Here the episode loop is a ``lax.scan`` inside jit, the env-batch axis is a
``vmap``, and multi-chip scale-out shards that axis over a
``jax.sharding.Mesh`` — envs are embarrassingly parallel along the batch
axis, so the only collectives are at the stats/learner boundary
(SURVEY.md §5.8).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from gym_flock_tpu.core.env import Env, EnvTransition, step_autoreset

__all__ = ["rollout", "batch_rollout", "batch_expert_rollout", "sharded_rollout", "make_env_mesh"]


def _resolve_policy(env: Env, policy):
    """policy: 'expert' | 'random' | callable(key, state, obs, params) -> action."""
    if policy == "expert":
        import inspect

        takes_key = "key" in inspect.signature(env.controller).parameters
        if takes_key:
            return lambda key, state, obs, params: env.controller(
                state, params, key=key
            )
        return lambda key, state, obs, params: env.controller(state, params)
    if policy == "random":

        def random_policy(key, state, obs, params):
            return env.action_space(params).sample(key)

        return random_policy
    if callable(policy):
        return policy
    raise ValueError(f"Unknown policy {policy!r}")


def rollout(
    env: Env,
    params,
    key: jax.Array,
    n_steps: int,
    policy="expert",
    auto_reset: bool = True,
    init_state=None,
    init_obs=None,
    keep_obs: bool = True,
):
    """Roll one env instance ``n_steps`` under ``policy``; returns (state, traj).

    The whole loop — reset, policy, dynamics, observation assembly — is a
    single ``lax.scan`` body, so ``jax.jit(partial(rollout, env))`` compiles
    to one XLA program with zero host round-trips per step.

    ``traj`` is an :class:`EnvTransition` pytree with a leading time axis.
    With ``keep_obs=False`` observations are dropped from the trajectory
    (saves HBM for pure-throughput benchmarking).
    """
    policy_fn = _resolve_policy(env, policy)

    if init_state is None:
        key, kreset = jax.random.split(key)
        state0, obs0 = env.reset_env(kreset, params)
    else:
        state0, obs0 = init_state, init_obs

    def body(carry, key_t):
        state, obs = carry
        k_pol, k_step = jax.random.split(key_t)
        action = policy_fn(k_pol, state, obs, params)
        if auto_reset:
            state2, obs2, reward, done, info = step_autoreset(
                env, k_step, state, action, params
            )
        else:
            state2, obs2, reward, done, info = env.step_env(
                k_step, state, action, params
            )
        t = EnvTransition(
            obs=obs if keep_obs else (),
            action=action,
            reward=reward,
            done=done,
            info={},
        )
        return (state2, obs2), t

    keys = jax.random.split(key, n_steps)
    (state, obs), traj = jax.lax.scan(body, (state0, obs0), keys)
    return state, traj


def batch_rollout(
    env: Env,
    params,
    key: jax.Array,
    n_envs: int,
    n_steps: int,
    policy="expert",
    auto_reset: bool = True,
    keep_obs: bool = True,
):
    """vmap :func:`rollout` over ``n_envs`` independent instances.

    Trajectory leaves have shape ``[n_envs, n_steps, ...]``.
    """
    keys = jax.random.split(key, n_envs)
    fn = partial(
        rollout,
        env,
        params,
        n_steps=n_steps,
        policy=policy,
        auto_reset=auto_reset,
        keep_obs=keep_obs,
    )
    return jax.vmap(fn)(keys)


def batch_expert_rollout(
    env,
    params,
    key: jax.Array,
    n_envs: int,
    n_steps: int,
    centralized: Optional[bool] = None,
    mesh: Optional[jax.sharding.Mesh] = None,
):
    """Batched FUSED expert rollout: one pairwise pass per env step.

    The throughput path for expert data generation on the flocking family —
    ``env.expert_rollout`` (obs pass carried into the next expert call,
    halving the dominant O(N^2) cost; bench.py's flagship metric) vmapped
    over ``n_envs`` fresh resets.  With ``mesh`` the env batch shards over
    its first axis via ``shard_map`` (envs are communication-free, so this
    scales linearly across chips).

    Returns ``(final_states, traj)`` with ``traj`` a dict of stacked
    per-step arrays ``u / values / network / reward`` of shape
    ``[n_envs, n_steps, ...]`` — (obs_t, u_t) pairs ready as imitation
    data (u_t is the expert label for the obs produced at step t-1).
    """

    def one(key):
        k_reset, k_roll = jax.random.split(key)
        state, _ = env.reset_env(k_reset, params)
        return env.expert_rollout(
            state, params, n_steps, centralized=centralized, key=k_roll
        )

    keys = jax.random.split(key, n_envs)
    if mesh is None:
        return jax.vmap(one)(keys)

    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    assert n_envs % mesh.devices.size == 0

    def local(keys):
        return jax.vmap(one)(keys)

    return jax.shard_map(
        local, mesh=mesh, in_specs=P(axis), out_specs=P(axis)
    )(keys)


def make_env_mesh(axis_name: str = "env", devices=None) -> jax.sharding.Mesh:
    """1-D device mesh over the env-batch axis (all local devices by default)."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    return jax.sharding.Mesh(np.asarray(devices), (axis_name,))


def sharded_rollout(
    env: Env,
    params,
    key: jax.Array,
    n_envs: int,
    n_steps: int,
    mesh: Optional[jax.sharding.Mesh] = None,
    policy="expert",
    auto_reset: bool = True,
    keep_obs: bool = False,
):
    """Shard ``batch_rollout`` over a device mesh along the env-batch axis.

    Each device rolls ``n_envs // n_devices`` instances; the per-step work
    never crosses devices (envs are independent), and the returned summary
    stats are combined with ``psum``-family collectives at the end.

    Returns ``(traj, stats)`` where stats = {'mean_reward', 'done_rate'}
    are global (already all-reduced) scalars.
    """
    if mesh is None:
        mesh = make_env_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    if n_envs % n_dev != 0:
        raise ValueError(f"n_envs={n_envs} must be divisible by mesh size {n_dev}")

    from jax.sharding import PartitionSpec as P

    def local_fn(keys):
        # keys: [n_envs/n_dev] local shard
        fn = partial(
            rollout,
            env,
            params,
            n_steps=n_steps,
            policy=policy,
            auto_reset=auto_reset,
            keep_obs=keep_obs,
        )
        _, traj = jax.vmap(fn)(keys)
        local_mean_r = jnp.mean(traj.reward)
        local_done = jnp.mean(traj.done.astype(jnp.float32))
        # learner-boundary collectives: global stats over the env axis
        mean_r = jax.lax.pmean(local_mean_r, axis)
        done_rate = jax.lax.pmean(local_done, axis)
        return traj, {"mean_reward": mean_r, "done_rate": done_rate}

    keys = jax.random.split(key, n_envs)
    shard_fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=(P(axis), P()),
    )
    return shard_fn(keys)
