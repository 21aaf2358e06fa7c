"""Flocking demo driver — the reference's README usage loop, plus batch mode.

Single-env mode mirrors the reference's interactive loop (README.md:18-30);
``--batch`` demonstrates the batched way: thousands of envs in one jitted
rollout.

    python examples/run_flocking.py --cpu -n 200 --render
    python examples/run_flocking.py --batch 4096 --steps 64
"""
import argparse
import sys
import timeit
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np

import jax


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="FlockingRelative-v0")
    p.add_argument("-n", "--steps", type=int, default=200)
    p.add_argument("--agents", type=int, default=100)
    p.add_argument("-r", "--render", action="store_true")
    p.add_argument("--batch", type=int, default=0, help="batched rollout mode")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    if args.batch:
        import gym_flock_tpu as gft
        from gym_flock_tpu.parallel import batch_rollout

        env, params = gft.make(args.env, n_agents=args.agents)
        t0 = timeit.default_timer()
        _, traj = jax.jit(
            lambda k: batch_rollout(
                env, params, k, n_envs=args.batch, n_steps=args.steps,
                policy="expert", keep_obs=False,
            )
        )(jax.random.key(args.seed))
        mean_r = float(np.mean(np.asarray(traj.reward)))  # fetch = sync
        dt = timeit.default_timer() - t0
        n = args.batch * args.steps
        print(f"{args.env}: {n} env-steps in {dt:.2f}s "
              f"({n/dt:,.0f} steps/s incl. compile), mean reward {mean_r:.3f}")
        return

    from gym_flock_tpu.compat import make_legacy

    env = make_legacy(args.env, n_agents=args.agents)
    env.seed(args.seed)
    obs = env.reset()
    total = 0.0
    t0 = timeit.default_timer()
    for t in range(args.steps):
        u = env.controller()
        obs, reward, done, _ = env.step(u)
        total += reward
        if args.render:
            env.render()
    dt = timeit.default_timer() - t0
    print(f"{args.env}: {args.steps} steps, cumulative reward {total:.2f}, "
          f"{args.steps/dt:,.1f} steps/s (single stream)")
    env.close()


if __name__ == "__main__":
    main()
