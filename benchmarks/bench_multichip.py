"""Multi-chip dp-scaling benchmark for the two headline metrics.

Measures the flagship fused FlockingRelative expert rollout (bench.py
metric 1) and the ExploreFull greedy loop (metric 3) sharded over a
``dp`` mesh spanning ALL visible devices, and reports per-device-count
rates plus scaling efficiency (rate_n / (n * rate_1)).  Envs are
embarrassingly parallel along the batch axis (SURVEY.md §5.8), so
efficiency should be ~1.0 on any real mesh.

Usage:
  python benchmarks/bench_multichip.py            # real devices, timed
  python benchmarks/bench_multichip.py --dryrun   # 8 virtual CPU devices,
                                                  # tiny shapes, validates
                                                  # the measurement program
                                                  # compiles + executes

Emits one JSON line per metric:
  {"metric": ..., "devices": n, "value": steps/s, "unit": "env-steps/s",
   "scaling_efficiency": r, "dryrun": bool}

Each timed call ends in a scalar value fetch, which waits for the
devices; rates are best-of-N.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

_DRYRUN = "--dryrun" in sys.argv
if _DRYRUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax
import jax.numpy as jnp
import numpy as np


from jax.sharding import Mesh, PartitionSpec as P

import gym_flock_tpu as gft
from gym_flock_tpu.utils.cache import enable_compile_cache


def best_of(fn, warm=1, iters=3):
    for _ in range(warm):
        fn()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def flagship_rate(devices, b_per_dev, n_steps, n_agents):
    """Fused expert+step+obs flocking rollout, env batch sharded over dp.

    The per-shard body is the exact bench.py metric-1 loop (one pairwise
    pass per step, full obs tuple consumed); shards never communicate —
    the only collective is the final psum of the checksum scalar.
    """
    from gym_flock_tpu.envs.flocking import (
        _instant_cost,
        _integrate,
        flocking_obs_expert_pass,
    )

    env, params = gft.make("FlockingRelative-v0", n_agents=n_agents)
    n_dev = len(devices)
    mesh = Mesh(np.asarray(devices), ("dp",))

    def shard(xs):  # [b_per_dev, N, 4] device-local
        def one(x):
            _, _, gx0, gy0, dvx0, dvy0 = flocking_obs_expert_pass(x, params)

            def body(carry, _):
                x, s_gx, s_gy, s_dvx, s_dvy = carry
                controls = jnp.stack((-s_gx - s_dvx, -s_dvy - s_gy), axis=1)
                u = jnp.clip(controls, -10.0, 10.0) / params.action_scalar
                x1 = _integrate(x, u * params.action_scalar, params.dt)
                values, network, gx1, gy1, dvx1, dvy1 = flocking_obs_expert_pass(
                    x1, params
                )
                out = _instant_cost(x1) + (
                    jnp.sum(values) + jnp.sum(network)
                ) * 1e-12
                return (x1, gx1, gy1, dvx1, dvy1), out

            (_, *_r), rs = jax.lax.scan(
                body, (x, gx0, gy0, dvx0, dvy0), None, length=n_steps
            )
            return jnp.sum(rs)

        return jax.lax.psum(jnp.sum(jax.vmap(one)(xs)), "dp")

    run = jax.jit(
        jax.shard_map(shard, mesh=mesh, in_specs=P("dp"), out_specs=P())
    )
    xs = jax.random.normal(
        jax.random.key(0), (n_dev * b_per_dev, n_agents, 4)
    ) * 0.1
    xs = jax.device_put(
        xs, jax.NamedSharding(mesh, P("dp"))
    )
    best = best_of(lambda: float(run(xs)))
    return n_dev * b_per_dev * n_steps / best


def explore_full_rate(devices, b_per_dev, n_steps, make_kwargs):
    """ExploreFull greedy expert + step, env batch sharded over dp; the
    graph bank rides replicated (a jit argument — closure capture would
    embed ~1 GB of bank constants in the HLO, ROADMAP r3)."""
    env, params = gft.make("ExploreFullEnv-v0", **make_kwargs)
    n_dev = len(devices)
    mesh = Mesh(np.asarray(devices), ("dp",))

    def shard(keys, params):  # keys [b_per_dev] device-local
        def one(key):
            state, _ = env.reset_env(key, params)

            def body(state, key_t):
                k1, k2 = jax.random.split(key_t)
                u = env.controller(state, params, key=k1, greedy=True)
                state, obs, r, d, _ = env.step_env(k2, state, u, params)
                chk = sum(
                    jnp.sum(l.astype(jnp.float32)) for l in jax.tree.leaves(obs)
                )
                return state, r + 1e-12 * chk

            _, rs = jax.lax.scan(body, state, jax.random.split(key, n_steps))
            return jnp.sum(rs)

        return jax.lax.psum(jnp.sum(jax.vmap(one)(keys)), "dp")

    run = jax.jit(
        jax.shard_map(
            shard, mesh=mesh, in_specs=(P("dp"), P()), out_specs=P()
        )
    )
    keys = jax.device_put(
        jax.random.split(jax.random.key(1), n_dev * b_per_dev),
        jax.NamedSharding(mesh, P("dp")),
    )
    best = best_of(lambda: float(run(keys, params)))
    return n_dev * b_per_dev * n_steps / best


def emit(metric, devices, value, eff, dryrun):
    print(
        json.dumps(
            {
                "metric": metric,
                "devices": devices,
                "value": round(value, 1),
                "unit": "env-steps/s",
                "scaling_efficiency": round(eff, 3) if eff is not None else None,
                "dryrun": dryrun,
            }
        ),
        flush=True,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", action="store_true")
    args = ap.parse_args()
    enable_compile_cache()

    devs = jax.devices()
    n = len(devs)
    if args.dryrun:
        flock_cfg = dict(b_per_dev=2, n_steps=2, n_agents=8)
        # procedural world (default ~1400-node budget): the real 5.7k-node
        # facility is pointless on virtual CPU devices and slows the
        # compile check; few robots keep the padded obs small
        ef_kwargs = dict(real_map=False, n_robots=8)
        ef_cfg = dict(b_per_dev=1, n_steps=2, make_kwargs=ef_kwargs)
    else:
        flock_cfg = dict(b_per_dev=8192 // max(n, 1), n_steps=64, n_agents=100)
        ef_cfg = dict(b_per_dev=512 // max(n, 1), n_steps=32, make_kwargs={})

    r1_flock = flagship_rate(devs[:1], **flock_cfg)
    rn_flock = (
        flagship_rate(devs, **flock_cfg) if n > 1 else r1_flock
    )
    emit(
        "env-steps/s (FlockingRelative fused, dp-sharded)", n, rn_flock,
        rn_flock / (n * r1_flock) if n > 1 else 1.0, args.dryrun,
    )

    r1_ef = explore_full_rate(devs[:1], **ef_cfg)
    rn_ef = explore_full_rate(devs, **ef_cfg) if n > 1 else r1_ef
    emit(
        "env-steps/s (ExploreFull greedy, dp-sharded)", n, rn_ef,
        rn_ef / (n * r1_ef) if n > 1 else 1.0, args.dryrun,
    )


if __name__ == "__main__":
    main()
