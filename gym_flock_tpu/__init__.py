"""gym_flock_tpu — accelerator-native multi-robot swarm environment engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
katetolstaya/gym-flock (reference layout: gym_flock/__init__.py:3-112):
continuous flocking with double-integrator dynamics, discrete graph-based
spatial coverage/exploration, shepherding, formation flying, and networked
LQR — each with its bundled expert controller for imitation-learning data
generation.

Core ideas
----------
* Environments are **pure function pairs** over immutable pytree state
  (``gym_flock_tpu.core.env``); ``jit(vmap(step))`` steps thousands of env
  instances per chip, ``shard_map`` over a ``jax.sharding.Mesh`` scales the
  env-batch axis across chips/hosts (``gym_flock_tpu.parallel``).
* All hot kernels are dense masked tensor ops with static shapes; variable
  graph topology uses the padded-buffer scheme the reference already
  pioneered (coverage.py:54-56), which is exactly what batched static-shape
  device code needs.
* A legacy class-based API with ``reset()/step()/controller()/render()``
  (``gym_flock_tpu.compat``) is provided for drop-in replacement of the
  reference's gym 0.11 envs.

Quick start
-----------
    import jax
    import gym_flock_tpu as gft

    env, params = gft.make("FlockingRelative-v0")
    key = jax.random.key(0)
    state, obs = env.reset(key, params)
    action = env.controller(state, params)
    state, obs, reward, done, info = env.step(key, state, action, params)
"""
from gym_flock_tpu.core.registry import make, register, registry
from gym_flock_tpu import _register_all  # noqa: F401  (populates registry)

__version__ = "0.1.0"

__all__ = ["make", "register", "registry", "__version__"]
