"""Train a GNN policy on a LARGE swarm — no dense adjacency anywhere.

At N >~ 1k a dense [N, N] adjacency is the memory wall (1 GB at N=16k per
env instance).  This example trains ``models.LargeAggregationGNN`` by
imitation on ``FlockingLarge-v0``: every pairwise product — the env's
observation features, the Turner expert, and the GNN's K-hop aggregation
(forward AND backward, via the custom VJP of ``ops.adjacency_matmul``) —
runs tile by tile with O(N) memory.

    python examples/train_flocking_large.py --agents 2048           # one GPU
    python examples/train_flocking_large.py --cpu --agents 64       # smoke
    python examples/train_flocking_large.py --agents 64 --shard-agents \
        --cpu  # agent-axis-sharded training step (virtual mesh on CPU)
"""
import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--agents", type=int, default=2048)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--envs", type=int, default=4)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--shard-agents", action="store_true",
                   help="shard the agent axis over all devices (model "
                        "parallelism for the swarm dimension)")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    if args.cpu:
        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        jax.config.update("jax_platforms", "cpu")

    import gym_flock_tpu as gft
    from gym_flock_tpu.parallel import LargeFlockingImitationTrainer
    from gym_flock_tpu.parallel.train import (
        collect_large_flocking_batch,
        save_checkpoint,
    )

    env, params = gft.make("FlockingLarge-v0", n_agents=args.agents)
    trainer = LargeFlockingImitationTrainer(env, params)

    key = jax.random.key(0)
    if args.shard_agents:
        assert args.agents % len(jax.devices()) == 0
        step, mesh = trainer.make_agent_sharded_train_step()
        print(f"agent axis sharded over {mesh.devices.size} devices")
        carry = trainer.init(jax.random.key(1))
        for i in range(args.iters):
            key, sub = jax.random.split(key)
            batch = collect_large_flocking_batch(
                env, params, sub, args.envs, args.steps
            )
            t0 = time.perf_counter()
            carry, loss = step(carry, batch)
            loss = float(loss)
            print(f"iter {i:3d}  loss {loss:.4f}  ({(time.perf_counter()-t0)*1e3:.0f} ms)")
        model_params = carry[0]
    else:
        carry = trainer.init(jax.random.key(1))
        for i in range(args.iters):
            key, sub = jax.random.split(key)
            t0 = time.perf_counter()
            carry, loss = trainer.train_step(carry, sub, args.envs, args.steps)
            loss = float(loss)
            print(f"iter {i:3d}  loss {loss:.4f}  ({(time.perf_counter()-t0)*1e3:.0f} ms)")
        model_params = carry[0]

    if args.checkpoint:
        save_checkpoint(args.checkpoint, model_params, None)
        print(f"saved {args.checkpoint}")


if __name__ == "__main__":
    main()
