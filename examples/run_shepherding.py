"""Shepherding demo driver — mirror of reference shepherding/test.py:1-38.

The reference loop: reset, drive the heuristic line-of-sight expert until
done, render each step, print the episode reward.  Here the same loop runs
through the pure-JAX env; ``--batch`` shows the batched form (one jitted
rollout over many episodes).

    python examples/run_shepherding.py --cpu -N 3 --render
    python examples/run_shepherding.py --batch 1024 --steps 100
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-N", "--episodes", type=int, default=10)
    p.add_argument("--steps", type=int, default=200, help="per-episode cap")
    p.add_argument("-r", "--render", action="store_true")
    p.add_argument("--batch", type=int, default=0, help="batched rollout mode")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    import gym_flock_tpu as gft

    env, params = gft.make("Shepherding-v0")

    if args.batch:
        from gym_flock_tpu.parallel import batch_rollout

        _, traj = batch_rollout(
            env, params, jax.random.key(args.seed),
            n_envs=args.batch, n_steps=args.steps, policy="expert",
        )
        rewards = np.asarray(traj.reward).sum(axis=-1)
        print(
            f"{args.batch} episodes x {args.steps} steps: "
            f"mean reward {rewards.mean():.2f} +- {rewards.std():.2f}"
        )
        return

    renderer = None
    if args.render:
        from gym_flock_tpu.render.plot import get_renderer

        renderer = get_renderer("Shepherding-v0", env, params)

    step = jax.jit(env.step_env)
    expert = jax.jit(env.controller)
    key = jax.random.key(args.seed)
    for ep in range(args.episodes):
        key, k_reset = jax.random.split(key)
        state, _ = env.reset_env(k_reset, params)
        episode_reward = 0.0
        for _ in range(args.steps):
            u = expert(state, params)
            key, k_step = jax.random.split(key)
            state, _, reward, done, _ = step(k_step, state, u, params)
            episode_reward += float(reward)
            if renderer is not None:
                renderer.draw(state)
            if bool(done):
                break
        print(episode_reward)
    if renderer is not None:
        renderer.close()


if __name__ == "__main__":
    main()
