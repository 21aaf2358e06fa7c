"""Kernel-level timings on one GPU: each hand-written kernel (the adjacency
product, the cell-list channel sums) against the plain version XLA
compiles, the XLA passes against their roofline, and the two routes of
ExploreFull's hide-nodes masks.

    python benchmarks/kernel_timings.py [--out FILE] [--trace DIR]

Times are medians of per-call wall times that end in ``block_until_ready``
(compilation excluded), each variant run in two interleaved rounds.  One
JSON object per measurement goes to stdout and, as a list, to ``--out``.
FLOP and byte counts are computed from the shapes:

* flocking sums: 33 float32 operations per agent pair (4 differences, r^2,
  one reciprocal, 1/r^4, the Turner factor, 9 masked products and sums);
* cell-list sums: the same per pair of every listed 128 x 128 tile (the
  valid slots of the candidate table, counted at the rollout's first and
  last states), for both routes;
* greedy row-min: one bf16 cost row per robot plus the env's blocked mask.

Peaks (NVIDIA H100 SXM data sheet, at 700 W): 67 TFLOP/s float32 outside
the tensor cores, 3.35 TB/s HBM.  A bf16 matrix product and a copy measured
in the same process show what this card reaches.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import gym_flock_tpu as gft
from gym_flock_tpu.ops import pallas_flocking as pf
from gym_flock_tpu.utils.cache import enable_compile_cache

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
FLOPS_PER_PAIR = 33
RESULTS = []


def emit(**row):
    RESULTS.append(row)
    print(json.dumps(row), flush=True)


def median_time(fn, *args, reps=10, rounds=1):
    """Median seconds per call of ``fn(*args)`` (compiled on first call)."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(rounds * reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def interleaved(variants, *args, reps=10):
    """{name: median seconds}, two rounds of every variant in turn."""
    out = {k: [] for k in variants}
    for _ in range(2):
        for name, fn in variants.items():
            out[name].append(median_time(fn, *args, reps=reps))
    return {k: statistics.median(v) for k, v in out.items()}


def calibrate(n=8192, copy_elems=256 * 2**20):
    a = jnp.ones((n, n), jnp.bfloat16)
    mm = jax.jit(lambda a: a @ a)
    t = median_time(mm, a)
    emit(what=f"calibration bf16 matmul {n}^3", seconds=t, tflops=2 * n**3 / t / 1e12)
    x = jnp.ones((copy_elems,), jnp.float32)
    cp = jax.jit(lambda x: x * 2.0)
    t = median_time(cp, x)
    emit(what=f"calibration {x.nbytes / 2**30:.2f} GiB read + write", seconds=t,
         tbytes_per_s=2 * x.nbytes / t / 1e12)


def swarm(n, b, f, seed=0):
    rng = np.random.RandomState(seed)
    side = np.sqrt(n / 2.5)  # ~2.5 agents per unit area
    x = jnp.asarray(rng.uniform(0, side, (b, n, 4)).astype(np.float32))
    h = jnp.asarray(rng.randn(b, n, f).astype(np.float32))
    return x, h


def adjacency(shapes=((2048, 16, 6), (2048, 16, 64), (16384, 1, 6), (16384, 1, 64))):
    zero = jnp.zeros((2,), jnp.int32)
    for n, b, f in shapes:
        x, h = swarm(n, b, f)
        variants = {"kernel": jax.jit(lambda x, h: pf._adj_matmul_triton(x, x, h, zero, 0.81))}
        variants["xla HIGHEST"] = jax.jit(lambda x, h: pf._adj_matmul_xla(x, x, h, zero, 0.81))

        def xla_default(x, h):
            d = x[..., :, None, :2] - x[..., None, :, :2]
            eye = jnp.eye(n, dtype=bool)
            adj = ((jnp.sum(d * d, -1) < 0.81) & ~eye).astype(jnp.float32)
            return adj @ h, jnp.sum(adj, -1)

        variants["xla default precision"] = jax.jit(xla_default)
        times = interleaved(variants, x, h)
        for name, t in times.items():
            emit(what="adjacency_matmul", variant=name, n=n, envs=b, f=f, seconds=t,
                 adjacency_bytes_if_materialized=4 * b * n * n)


def routed(module, name, impls, run, *args, reps=5):
    """Median seconds of ``run(*args)`` with ``module.name`` set to each
    implementation in turn (two interleaved rounds, caches cleared)."""
    original = getattr(module, name)
    out = {k: [] for k in impls}
    try:
        for _ in range(2):
            for key, impl in impls.items():
                setattr(module, name, impl)
                jax.clear_caches()
                out[key].append(median_time(jax.jit(run), *args, reps=reps))
    finally:
        setattr(module, name, original)
        jax.clear_caches()
    return {k: statistics.median(v) for k, v in out.items()}


def adjacency_end_to_end(n_train=2048, n_grad=16384):
    """The two adjacency routes through whole training steps: the
    large-swarm imitation step at N=2048 and a K-hop GNN gradient at
    N=16384."""
    from gym_flock_tpu.models import LargeAggregationGNN
    from gym_flock_tpu.parallel import LargeFlockingImitationTrainer

    routes = {"kernel": pf._adj_tile, "xla": pf._adj_matmul_xla}
    env, params = gft.make("FlockingLarge-v0", n_agents=n_train)
    trainer = LargeFlockingImitationTrainer(env, params)
    carry = trainer.init(jax.random.key(1))
    times = routed(pf, "_adj_tile", routes,
                   lambda c, k: trainer.train_step(c, k, 4, 4), carry, jax.random.key(2))
    for name, t in times.items():
        emit(what=f"LargeFlockingImitationTrainer.train_step N={n_train} 4 envs x 4 steps",
             route=name, seconds=t)
    x, h = swarm(n_grad, 1, 6)
    model = LargeAggregationGNN(comm_radius2=0.81)
    gp = model.init(jax.random.key(0), x[0], h[0])
    times = routed(pf, "_adj_tile", routes,
                   jax.grad(lambda p: jnp.sum(model.apply(p, x[0], h[0]) ** 2)), gp)
    for name, t in times.items():
        emit(what=f"LargeAggregationGNN grad N={n_grad} (3 hops)", route=name, seconds=t)


def flocking_sums(shapes=((4096, 16), (16384, 1))):
    for n, b in shapes:
        x, _ = swarm(n, b, 1)
        for channels in ("core", "full"):
            fn = jax.jit(lambda x, c=channels: pf._flocking_sums_xla(x, x, 0, 0, 0.9, 0.81, c))
            t = median_time(fn, x)
            flops = FLOPS_PER_PAIR * b * n * n
            emit(what="flocking_sums (XLA)", channels=channels, n=n, envs=b, seconds=t,
                 gflops_per_s=flops / t / 1e9, share_of_f32_peak=flops / t / PEAK_F32_FLOPS)


def sparse(trace_dir=None, N=65536, T=32):
    from gym_flock_tpu.ops import sparse_flocking as sf

    env, params = gft.make("FlockingSparse-v0", n_agents=N)
    k1, k2 = jax.random.split(jax.random.key(0))
    pos = jax.random.uniform(k1, (N, 2)) * jnp.sqrt(N * 1.0)
    x = jnp.concatenate([pos, jax.random.normal(k2, (N, 2))], axis=-1)
    state = env.init_state(x, params)
    def run(s):
        traj = env.expert_rollout(s, params, n_steps=T)[1]
        return jnp.sum(traj["reward"]) + 1e-12 * jnp.sum(traj["values"])

    def xla(xs, table, cr, cr2, expert):
        return jax.vmap(lambda a, t: sf._sparse_sums_sorted(a, t, cr, cr2, expert=expert))(
            xs, table)

    times = routed(sf, "_table_sums", {"kernel": sf._table_sums, "xla": xla}, run, state)
    # the rollout's candidate table (skin = comm_radius) at its first and
    # last states: the kernel visits only the listed tiles, the XLA scan
    # all k_max slots of every row block, the unlisted ones masked
    final = jax.jit(lambda s: env.expert_rollout(s, params, n_steps=T)[0])(state)
    n_rb = N // sf.BLOCK
    listed = [int(jnp.sum(sf.verlet_build(s.x, params.comm_radius, params.comm_radius).table >= 0))
              for s in (state, final)]
    pairs = statistics.mean(listed) * sf.BLOCK * sf.BLOCK
    for name, t in times.items():
        emit(what="FlockingSparse-v0 expert rollout", route=name, n=N, steps=T,
             seconds_per_step=t / T, listed_tiles_first_last=listed,
             mean_listed_tiles_per_row_block=statistics.mean(listed) / n_rb, k_max=16,
             listed_pairs_per_step=pairs,
             share_of_f32_peak_on_listed_pairs=FLOPS_PER_PAIR * pairs * T / t / PEAK_F32_FLOPS)
    run = jax.jit(run)
    dense = jax.jit(lambda x: pf.flocking_sums(x, 0.9, 0.81))
    td = median_time(dense, x, reps=3)
    emit(what="dense flocking_sums at the same N", n=N, seconds=td)
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(run(state))


def rowmin(B=512, R=100, T=5759):
    """The greedy expert's packed row-min at ExploreFullEnv-v0's shape (the
    real map's 5,759 targets) on random costs and masks."""
    from gym_flock_tpu.envs.coverage import _packed_greedy_min as packed_greedy_min

    rng = np.random.RandomState(0)
    cost = jnp.asarray(rng.randint(0, 200, (1, T, T)).astype(np.float32), jnp.bfloat16)
    g = jnp.zeros((B,), jnp.int32)
    cur = jnp.asarray(rng.randint(0, T, (B, R)), jnp.int32)
    blocked = jnp.asarray(rng.rand(B, T) < 0.5)
    fn = jax.jit(jax.vmap(packed_greedy_min, in_axes=(None, 0, 0, 0)))
    t = median_time(fn, cost, g, cur, blocked)
    contract = B * R * T * 2 + B * T + B * R * 4
    emit(what="greedy row-min (XLA gather + packed min)", envs=B, robots=R, targets=T,
         seconds=t, contract_bytes=contract, share_of_hbm_peak=contract / t / PEAK_HBM_BYTES)


def coverage_routes(B=512):
    """ExploreFullEnv-v0 greedy expert + step + full obs, scanned 16 steps,
    with the hide-nodes masks as one-hot matmuls and as gathers."""
    env, params = gft.make("ExploreFullEnv-v0")

    def rollout(key, p):
        def one(key):
            s, _ = env.reset_env(key, p)

            def body(s, k):
                k1, k2 = jax.random.split(k)
                u = env.controller(s, p, key=k1, greedy=True)
                s, obs, r, _, _ = env.step_env(k2, s, u, p)
                chk = sum(jnp.sum(l.astype(jnp.float32)) for l in jax.tree.leaves(obs))
                return s, r + 1e-12 * chk

            return jnp.sum(jax.lax.scan(body, s, jax.random.split(key, 16))[1])

        return jnp.sum(jax.vmap(one)(jax.random.split(key, B)))

    # params go in as an argument: closed over, the bank would be
    # embedded in the program as constants
    run = jax.jit(rollout)
    variants = {
        f"hide_mm={v}": (lambda key, p=params.replace(hide_mm=v): run(key, p))
        for v in (True, False)
    }
    times = interleaved(variants, jax.random.key(0), reps=3)
    for name, t in times.items():
        emit(what=f"ExploreFullEnv-v0 x {B} greedy expert + step, 16 steps", route=name,
             seconds=t, env_steps_per_s=B * 16 / t)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--trace", default="")
    ap.add_argument("--parts", default="calibrate,adjacency,flocking_sums,rowmin,"
                    "adjacency_end_to_end,coverage_routes,sparse")
    args = ap.parse_args()
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    emit(what="device", kind=dev.device_kind, nvidia_smi=card, jax=jax.__version__)
    for part in args.parts.split(","):
        if part == "sparse":
            sparse(args.trace or None)
        else:
            globals()[part]()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(RESULTS, indent=1))


if __name__ == "__main__":
    main()
