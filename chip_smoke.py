#!/usr/bin/env python3
"""Run the swarm engine's main paths once on an NVIDIA GPU and check them.

    python chip_smoke.py             # one GPU: phases 1-5 at full width
    python chip_smoke.py --multi     # four GPUs: the multi-device paths only
    python chip_smoke.py --rehearse [--multi]   # tiny sizes on the CPU

Phases (one process, one card), each through the user entry points and
each compared with the repo's plain reference:

1. Flagship data generation: ``batch_expert_rollout`` on
   FlockingRelative-v0, 100 agents x 8,192 envs x 16 steps (the trajectory
   holds the [N, N] network).  Teacher-forced check: at the card's state
   x_15 the float64 CPU ``env.expert`` + ``env.step_env`` must give the
   card's u_15 and x_16, and float64 features at the card's x_16 its
   observation.  Whole trajectories are not compared: they diverge
   chaotically.
2. Imitation learning: ``FlockingImitationTrainer`` steps at 1,024 envs
   (loss finite and falling; one step's gradients against the CPU in
   float32 at precision HIGHEST) and one ``DaggerTrainer`` iteration.
3. Coverage: Coverage-v0 x 8,192 envs and ExploreFullEnv-v0 (100 robots,
   real 5,759-node map) x 512 envs under the greedy expert; the card's
   actions must equal the CPU's at the card's states EXACTLY (integer
   arithmetic, exact in f32).
4. Large swarms: FlockingLarge-v0 N=4,096 x 16 envs, expert + step + obs,
   centralized and decentralized, against float64 dense CPU kernels; the
   adjacency kernel against the plain XLA product
   (N=2,048 x 16 envs and N=16,384), its custom-VJP gradient against
   autodiff of the product; one ``LargeFlockingImitationTrainer`` step at
   N=2,048.
5. Sparse swarms: FlockingSparse-v0 N=65,536 expert rollout of 32 steps;
   at its final state the cell-list channel sums against the dense sums,
   and the table-driven kernel against the XLA scan.

``--multi`` (four cards, nothing else): the flagship rollout at 4 x 8,192
envs over a 4-device env mesh against the same keys on one card; one dp=4
``FlockingImitationTrainer`` step against the single-card step on the same
global batch; ``agent_sharded_rollout`` over a (1, 4) mesh with
FlockingLarge N=16,384 in ring mode, its sums against the single-card
dense sums at the same state.

Every line before the last reports a phase: compile seconds, the compiled
program's memory analysis, and each max error beside its tolerance.  Any
failure raises and exits nonzero.  The last line is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.  ``--rehearse``
runs the same code at tiny sizes on the CPU and prints no result line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

HERE = Path(__file__).resolve().parent

FULL = dict(
    flag_envs=8192, flag_steps=16,
    il_envs=1024, il_steps=8, il_iters=5, dagger_envs=256,
    cov_envs=8192, explore_envs=512, cov_steps=8,
    large_n=4096, large_envs=16, adj_n=2048, adj_envs=16, adj_big_n=16384,
    sparse_n=65536, sparse_steps=32,
    multi_flag_envs=8192, multi_il_envs=1024, multi_ring_n=16384,
)
TINY = dict(
    flag_envs=64, flag_steps=4,
    il_envs=16, il_steps=4, il_iters=5, dagger_envs=8,
    cov_envs=64, explore_envs=4, cov_steps=4,
    large_n=256, large_envs=2, adj_n=256, adj_envs=2, adj_big_n=512,
    sparse_n=1024, sparse_steps=4,
    multi_flag_envs=16, multi_il_envs=16, multi_ring_n=512,
)


def log(msg):
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def check(phase, what, err, tol):
    """Print ``err`` beside ``tol``; raise when it is out of tolerance."""
    ok = bool(err <= tol)
    log(f"[{phase}] {what}: max error {err:.3e} (tolerance {tol:.1e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{phase}: {what} max error {err} > {tol}")


def build(phase, fn, *args):
    """jit + lower + compile ``fn`` at ``args``; print compile time and
    the memory analysis; return the compiled program."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    dt = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    if ma is None:
        mem = "not reported"
    else:
        mem = ", ".join(
            f"{k} {getattr(ma, k + '_size_in_bytes') / 2**30:.3f} GiB"
            for k in ("argument", "output", "temp")
        )
    log(f"[{phase}] compile {dt:.1f} s; memory: {mem}")
    return compiled


def rel_err(got, want):
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))


def scaled_err(got, want, scale):
    """max |got - want| / (1 + scale): ``scale`` is the sum of the absolute
    values of the terms a float32 sum added, which bounds its rounding."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (1.0 + np.asarray(scale))))


def term_scales(x, comm_radius, comm_radius2, centralized, action_scalar=1.0):
    """float64 [N, 6] feature and [N, 2] expert term scales at one swarm
    state ``x`` [N, 4] (see :func:`scaled_err`)."""
    import jax.numpy as jnp

    from gym_flock_tpu.envs.flocking import _pairwise_channels

    dx, dy, dvx, dvy, r2 = _pairwise_channels(x)
    adj = (r2 < comm_radius2).astype(x.dtype)
    inv = 1.0 / r2
    feat = jnp.stack([
        jnp.sum(t * adj, axis=1) for t in (
            jnp.abs(dvx), jnp.abs(dx) * inv * inv, jnp.abs(dx) * inv,
            jnp.abs(dvy), jnp.abs(dy) * inv * inv, jnp.abs(dy) * inv,
        )
    ], axis=1)
    mask = 1.0 if centralized else adj
    grad = lambda d: jnp.where(r2 > comm_radius, 0.0, 2.0 * jnp.abs(d) * (inv * inv + inv))
    ctrl = jnp.stack([
        jnp.sum((grad(dx) + jnp.abs(dvx)) * mask, axis=1),
        jnp.sum((grad(dy) + jnp.abs(dvy)) * mask, axis=1),
    ], axis=1) / action_scalar
    return feat, ctrl


def kernel(fn, ctx):
    """A Pallas kernel as compiled for the card; interpreted off it."""
    return fn if ctx["platform"] == "gpu" else partial(fn, interpret=True)


def check_vs_f64(phase, what, got, plain, ref64):
    """A kernel's float32 result must be as close to the float64 reference
    as the plain XLA float32 pass is (twice its error, plus 1e-6)."""
    err_k, err_x = rel_err(got, ref64), rel_err(plain, ref64)
    log(f"[{phase}] {what}: plain XLA float32 error {err_x:.3e}")
    check(phase, what + " vs float64", err_k, 2 * err_x + 1e-6)


def near_cutoff_rows(x, cutoffs, rtol=1e-5):
    """[B, N] bool: agents with a neighbour whose squared distance lies
    within ``rtol`` of a cutoff.  A float32 r^2 there may fall on the
    other side of the cutoff than the float64 one, which flips a whole
    neighbour term; such agents are left out of float32-vs-float64
    comparisons, and counted."""
    import numpy as np

    d = x[:, :, None, :2] - x[:, None, :, :2]
    r2 = np.sum(d * d, axis=-1)
    near = np.zeros(r2.shape[:2], bool)
    for c in cutoffs:
        near |= np.any(np.abs(r2 - c) <= rtol * c, axis=-1)
    return near


# =============================================================================
# phases on one card
# =============================================================================


def phase_flagship(S, ctx):
    import jax
    import numpy as np

    import gym_flock_tpu as gft
    from gym_flock_tpu.envs.flocking import flocking_features
    from gym_flock_tpu.parallel import batch_expert_rollout

    P = "1 flagship"
    env, params = gft.make("FlockingRelative-v0", n_agents=100)
    E, T = S["flag_envs"], S["flag_steps"]
    key = jax.random.key(ctx["seed"])

    run_t = build(P, lambda k: batch_expert_rollout(env, params, k, E, T), key)
    final, traj = run_t(key)
    jax.block_until_ready(traj)
    t0 = time.perf_counter()
    final, traj = run_t(key)
    jax.block_until_ready(traj)
    dt = time.perf_counter() - t0
    log(f"[{P}] {E} envs x {T} steps x 100 agents, trajectory network "
        f"{traj['network'].nbytes / 2**30:.2f} GiB, rollout {dt:.3f} s")
    run_prev = build(P, lambda k: batch_expert_rollout(env, params, k, E, T - 1)[0].x, key)
    x_prev = np.asarray(run_prev(key))  # the card's x_{T-1}
    u_last = np.asarray(traj["u"][:, -1])
    x_last = np.asarray(final.x)
    values = np.asarray(traj["values"][:, -1])
    network = np.asarray(traj["network"][:, -1])
    reward = np.asarray(traj["reward"][:, -1])
    del traj, final
    for v in (x_prev, u_last, x_last, values, network, reward):
        assert np.all(np.isfinite(v)), "non-finite flagship output"

    with jax.enable_x64(True), jax.default_device(ctx["cpu"]):
        p64 = params.replace()
        xp = x_prev.astype(np.float64)

        def ref(x):
            s = env.init_state(x, p64)
            u = env.expert(s, p64)
            s2, _, _, _, _ = env.step_env(jax.random.key(0), s, u, p64)
            return u, s2.x

        u_ref, x_ref = jax.jit(jax.vmap(ref))(xp)
        u_ref, x_ref = np.asarray(u_ref), np.asarray(x_ref)
        scales = jax.jit(jax.vmap(partial(
            term_scales, comm_radius=p64.comm_radius, comm_radius2=p64.comm_radius2,
            centralized=p64.centralized, action_scalar=p64.action_scalar,
        )))
        u_scale = np.asarray(scales(xp)[1])
        v_scale = np.asarray(scales(x_last.astype(np.float64))[0])

        def obs(x):
            vals, adj, adj_mean, r2 = flocking_features(x, p64.comm_radius2)
            return vals, adj_mean, -np.float64(1.0) * jax.numpy.sum(
                jax.numpy.var(x[:, 2:4], axis=0)
            )

        v_ref, n_ref, r_ref = (
            np.asarray(a) for a in jax.jit(jax.vmap(obs))(x_last.astype(np.float64))
        )

    # the centralized expert cuts the Turner gradient at r^2 = comm_radius
    near = near_cutoff_rows(xp, (params.comm_radius, params.comm_radius2))
    keep = ~near
    log(f"[{P}] agents next to a cutoff (left out of the u check): "
        f"{int(near.sum())} of {near.size}")
    assert near.mean() < 1e-3
    # tolerance for float32 sums (u, values): 1e-5 of (1 + the sum of the
    # absolute terms), ~20x the float32 rounding the CPU shows at 2,048 envs
    check(P, "expert u at the card's x_15 (float64 CPU, term-scaled)",
          scaled_err(u_last[keep], u_ref[keep], u_scale[keep]), 1e-5)
    check(P, "x_16 = step(x_15, u) (float64 CPU)", float(np.max(np.abs(x_last - x_ref))), 1e-5)
    nearo = near_cutoff_rows(x_last.astype(np.float64), (params.comm_radius2,))
    check(P, "obs values at the card's x_16 (term-scaled)",
          scaled_err(values[~nearo], v_ref[~nearo], v_scale[~nearo]), 1e-5)
    check(P, "obs network at the card's x_16", float(np.max(np.abs(network[~nearo] - n_ref[~nearo]))), 1e-6)
    check(P, "reward at the card's x_16", rel_err(reward, r_ref), 1e-5)


def phase_imitation(S, ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gym_flock_tpu as gft
    from gym_flock_tpu.parallel import DaggerTrainer, FlockingImitationTrainer
    from gym_flock_tpu.parallel.train import collect_flocking_batch

    P = "2 imitation"
    env, params = gft.make("FlockingRelative-v0", n_agents=100)
    trainer = FlockingImitationTrainer(env, params)
    carry = trainer.init(jax.random.key(ctx["seed"] + 1))
    E, T = S["il_envs"], S["il_steps"]
    k_batch = jax.random.key(ctx["seed"] + 2)
    step = build(P, lambda c, k: trainer.train_step(c, k, None, E, T), carry, k_batch)
    losses = []
    for _ in range(S["il_iters"]):
        carry, loss = step(carry, k_batch)  # same batch: the loss must fall
        losses.append(float(loss))
    log(f"[{P}] FlockingImitationTrainer {E} envs x {T} steps, losses {losses}")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses

    feats, adj, acts = jax.jit(partial(collect_flocking_batch, env, params),
                               static_argnums=(1, 2))(k_batch, E, T)
    grad_fn = jax.jit(jax.grad(trainer.loss_fn))
    g_card = grad_fn(carry[0], feats, adj, acts)
    host = lambda t: jax.tree.map(np.asarray, t)
    g_card, p_host = host(g_card), host(carry[0])
    batch = host((feats, adj, acts))
    del feats, adj, acts
    with jax.default_device(ctx["cpu"]), jax.default_matmul_precision("highest"):
        g_ref = host(jax.jit(jax.grad(trainer.loss_fn))(p_host, *batch))
    errs = jax.tree.leaves(jax.tree.map(
        lambda a, b: float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)),
        g_card, g_ref,
    ))
    # tolerance: the card runs the model's float32 matmuls at default
    # precision (TF32, 10-bit mantissa, ~5e-4 relative per product), the
    # reference at HIGHEST; 2e-2 of each leaf's gradient norm
    check(P, "gradient leaves vs CPU float32 HIGHEST (relative norm)", max(errs), 2e-2)

    dagger = DaggerTrainer(env, params, capacity=4 * S["dagger_envs"] * 16)
    state = dagger.init(jax.random.key(ctx["seed"] + 3))
    it = build(P, lambda s, k: dagger.iteration(s, k, jnp.float32(1.0), S["dagger_envs"], 16, 4),
               state, k_batch)
    state, dloss = it(state, k_batch)
    log(f"[{P}] DaggerTrainer iteration {S['dagger_envs']} envs x 16 steps, "
        f"loss {float(dloss):.4f}, buffer {int(state.filled)}")
    assert np.isfinite(float(dloss)) and int(state.filled) == S["dagger_envs"] * 16


def _flock(n, seed, density=2.5):
    """[1, n, 4] uniform swarm at ``density`` agents per unit area."""
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.RandomState(seed)
    side = np.sqrt(n / density)
    pos = rng.uniform(0, side, (1, n, 2))
    return jnp.asarray(np.concatenate([pos, rng.randn(1, n, 2)], -1).astype(np.float32))


def _one_with(params, key, env, T):
    import jax

    k0, kr = jax.random.split(key)
    s, _ = env.reset_env(k0, params)

    def body(s, k):
        k1, k2 = jax.random.split(k)
        u = env.controller(s, params, key=k1, greedy=True)
        s2, _, _, _, _ = env.step_env(k2, s, u, params)
        return s2, (s, jax.random.key_data(k1), u)

    _, out = jax.lax.scan(body, s, jax.random.split(kr, T))
    return out


def phase_coverage(S, ctx):
    import jax
    import numpy as np

    import gym_flock_tpu as gft
    from gym_flock_tpu.envs.coverage import _hide_mm_active

    P = "3 coverage"
    for env_id, kw, B in (
        ("Coverage-v0", dict(n_graphs=4), S["cov_envs"]),
        ("ExploreFullEnv-v0", {}, S["explore_envs"]),
    ):
        t0 = time.perf_counter()
        env, params = gft.make(env_id, **kw)
        # the expert's packed row-min over the bf16 cost copy, and on
        # ExploreFull the one-hot hide-mask matmuls, are what runs here
        assert {"cost_pack_ok", "graph_cost_bf16"} <= set(params.bank), env_id
        log(f"[{P}] {env_id}: bank built in {time.perf_counter() - t0:.1f} s, "
            f"{params.n_robots} robots, {params.max_nodes} nodes, packed bf16 "
            f"row-min expert, one-hot hide masks {'on' if _hide_mm_active(params) else 'off'}")
        T = S["cov_steps"]
        keys = jax.random.split(jax.random.key(ctx["seed"] + 4), B)
        run = build(P, lambda p, ks: jax.vmap(lambda k: _one_with(p, k, env, T))(ks),
                    params, keys)
        states, kdata, u = run(params, keys)
        states, kdata, u = jax.tree.map(np.asarray, (states, kdata, u))
        flat = lambda a: a.reshape((-1,) + a.shape[2:])
        states, kdata, u = jax.tree.map(flat, (states, kdata, u))
        with jax.default_device(ctx["cpu"]):
            p_cpu = jax.device_put(params, ctx["cpu"])
            u_ref = jax.jit(jax.vmap(
                lambda s, kd: env.controller(
                    s, p_cpu, key=jax.random.wrap_key_data(kd), greedy=True
                )
            ))(states, kdata)
        u_ref = np.asarray(u_ref)
        mism = int(np.sum(u != u_ref))
        log(f"[{P}] {env_id} x {B} envs x {T} steps: greedy actions differing "
            f"from the CPU at the card's states: {mism} of {u.size} (must be 0)")
        assert mism == 0, f"{env_id}: {mism} greedy actions differ from the CPU"


def phase_large(S, ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gym_flock_tpu as gft
    from gym_flock_tpu.envs.flocking import flocking_features, turner_controller
    from gym_flock_tpu.ops import pallas_flocking as pf
    from gym_flock_tpu.parallel import LargeFlockingImitationTrainer

    P = "4 large"
    N, B = S["large_n"], S["large_envs"]
    for centralized in (True, False):
        env, params = gft.make("FlockingLarge-v0", n_agents=N, centralized=centralized)
        keys = jax.random.split(jax.random.key(ctx["seed"] + 5), B)

        def one(k, params=params, env=env):
            s, _ = env.reset_env(k, params)
            u = env.controller(s, params)
            s2, (vals, deg), r, _, _ = env.step_env(k, s, u, params)
            return s.x, u, s2.x, vals, deg, r

        run = build(P, jax.vmap(one), keys)
        x0, u, x1, vals, deg, r = (np.asarray(a) for a in run(keys))
        assert np.all(np.isfinite(r)) and np.all(np.isfinite(x1))
        tag = "centralized" if centralized else "decentralized"
        cut = (params.comm_radius, params.comm_radius2)
        errs = {"u": [], "v": [], "deg": []}
        with jax.enable_x64(True), jax.default_device(ctx["cpu"]):
            p64 = params.replace()
            ctrl = jax.jit(partial(turner_controller, params=p64, centralized=centralized))
            feats = jax.jit(partial(flocking_features, comm_radius2=p64.comm_radius2))
            scales = jax.jit(partial(
                term_scales, comm_radius=p64.comm_radius, comm_radius2=p64.comm_radius2,
                centralized=centralized, action_scalar=p64.action_scalar,
            ))
            for b in range(min(B, 4)):  # float64 dense references of 4 envs
                x0b, x1b = x0[b].astype(np.float64), x1[b].astype(np.float64)
                u_ref = np.asarray(ctrl(x0b))
                v_ref, adj, _, _ = (np.asarray(a) for a in feats(x1b))
                u_scale = np.asarray(scales(x0b)[1])
                v_scale = np.asarray(scales(x1b)[0])
                k0 = ~near_cutoff_rows(x0b[None], cut)[0]
                k1 = ~near_cutoff_rows(x1b[None], cut[1:])[0]
                errs["u"].append(scaled_err(u[b][k0], u_ref[k0], u_scale[k0]))
                errs["v"].append(scaled_err(vals[b][k1], v_ref[k1], v_scale[k1]))
                errs["deg"].append(float(np.max(np.abs(deg[b][k1] - adj.sum(1)[k1]))))
        # float32 sums: 1e-5 of (1 + the sum of the absolute terms)
        check(P, f"N={N} {tag} expert u (float64 dense CPU, term-scaled)", max(errs["u"]), 1e-5)
        check(P, f"N={N} {tag} obs values (float64 dense CPU, term-scaled)", max(errs["v"]), 1e-5)
        check(P, f"N={N} {tag} degree (float64 dense CPU)", max(errs["deg"]), 0.0)

    zero = jnp.zeros((2,), jnp.int32)

    # the adjacency kernel against the plain XLA product, at two widths
    k_adj = kernel(pf._adj_matmul_triton, ctx)
    for n, b, f in ((S["adj_n"], S["adj_envs"], 6), (S["adj_big_n"], 1, 64)):
        rng = np.random.RandomState(ctx["seed"])
        side = np.sqrt(n / 2.5)  # ~2.5 agents per unit area: a few neighbours each
        x = jnp.asarray(rng.uniform(0, side, (b, n, 4)).astype(np.float32))
        h = jnp.asarray(rng.randn(b, n, f).astype(np.float32))
        k_run = build(P, lambda x, h: k_adj(x, x, h, zero, 0.81), x, h)
        x_run = build(P, lambda x, h: pf._adj_matmul_xla(x, x, h, zero, 0.81), x, h)
        (ok_, okd), (ox, oxd) = k_run(x, h), x_run(x, h)
        # tolerance: both are float32-exact products (bf16x3 split in the
        # kernel, HIGHEST in XLA) that sum in different orders
        check(P, f"adjacency kernel vs XLA, N={n} x {b} envs, F={f}", rel_err(ok_, ox), 1e-5)
        check(P, f"adjacency kernel degree, N={n}", float(np.max(np.abs(np.asarray(okd) - np.asarray(oxd)))), 0.0)

    n, f = S["adj_n"], 6
    rng = np.random.RandomState(ctx["seed"] + 1)
    x = jnp.asarray(rng.uniform(0, np.sqrt(n / 2.5), (n, 4)).astype(np.float32))
    h = jnp.asarray(rng.randn(n, f).astype(np.float32))
    co = jnp.asarray(rng.randn(n, f).astype(np.float32))
    g_vjp = jax.jit(jax.grad(lambda hv: jnp.sum(pf.adjacency_matmul(x, hv, 0.81) * co)))(h)
    g_ad = jax.jit(jax.grad(lambda hv: jnp.sum(
        (lambda o, d: o / jnp.where(d == 0, 1.0, d)[:, None])(*pf._adj_matmul_xla(x, x, hv, zero, 0.81)) * co
    )))(h)
    check(P, f"adjacency custom-VJP gradient vs autodiff of the product, N={n}", rel_err(g_vjp, g_ad), 1e-5)

    env, params = gft.make("FlockingLarge-v0", n_agents=S["adj_n"])
    trainer = LargeFlockingImitationTrainer(env, params)
    carry = trainer.init(jax.random.key(ctx["seed"] + 6))
    k = jax.random.key(ctx["seed"] + 7)
    step = build(P, lambda c, k: trainer.train_step(c, k, 4, 4), carry, k)
    carry, loss = step(carry, k)
    log(f"[{P}] LargeFlockingImitationTrainer N={S['adj_n']} step, loss {float(loss):.4f}")
    assert np.isfinite(float(loss))


def phase_sparse(S, ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gym_flock_tpu as gft
    from gym_flock_tpu.ops import sparse_flocking as sf
    from gym_flock_tpu.ops.pallas_flocking import flocking_sums_block
    from gym_flock_tpu.ops.sparse_flocking import flocking_sums_sparse

    P = "5 sparse"
    N, T = S["sparse_n"], S["sparse_steps"]
    env, params = gft.make("FlockingSparse-v0", n_agents=N)
    k1, k2 = jax.random.split(jax.random.key(ctx["seed"] + 8))
    pos = jax.random.uniform(k1, (N, 2)) * jnp.sqrt(N * 1.0)  # ~1 agent / unit^2
    x = jnp.concatenate([pos, jax.random.normal(k2, (N, 2))], axis=-1)
    state = env.init_state(x, params)
    run = build(P, lambda s: env.expert_rollout(s, params, n_steps=T), state)
    final, traj = run(state)
    jax.block_until_ready(traj)
    t0 = time.perf_counter()
    final, traj = run(state)
    jax.block_until_ready(traj)
    log(f"[{P}] N={N} expert rollout {T} steps: {time.perf_counter() - t0:.3f} s")
    assert bool(jnp.all(jnp.isfinite(final.x))) and bool(jnp.all(jnp.isfinite(traj["reward"])))

    xf = final.x
    cr, cr2 = params.comm_radius, params.comm_radius2
    dense = build(P, lambda x: flocking_sums_block(x, x, 0, 0, cr, cr2), xf)(xf)
    for channels, chans in (("core", list(range(9))), ("expert", [10, 11])):
        got = build(P, lambda x: flocking_sums_sparse(x, cr, cr2, channels=channels), xf)(xf)
        want, g = np.asarray(dense)[:, chans], np.asarray(got)[:, chans]
        # tolerance: the pruning is exact, so only float32 summation order
        # differs; 1e-4 of (1 + |sum|)
        check(P, f"N={N} cell-list {channels} channel sums vs dense", rel_err(g, want), 1e-4)
    deg_err = float(np.max(np.abs(np.asarray(got)[:, 8] - np.asarray(dense)[:, 8])))
    check(P, f"N={N} cell-list degree vs dense", deg_err, 0.0)

    # the table-driven kernel against the XLA scan, at the same sorted state
    perm = sf.hilbert_order(xf, cr)
    xs = xf[perm]
    table, overflow = sf.block_pair_table(xs, cr, 16)
    assert not bool(overflow)
    k_sums = kernel(sf._table_sums_triton, ctx)
    for expert in (False, True):
        got = build(P, lambda x, t: k_sums(x[None], t[None], cr, cr2, expert)[0],
                    xs, table)(xs, table)
        plain = build(P, lambda x, t: sf._sparse_sums_sorted(x, t, cr, cr2, expert=expert),
                      xs, table)(xs, table)
        with jax.enable_x64(True), jax.default_device(ctx["cpu"]):
            x64, t64 = np.asarray(xs, np.float64), np.asarray(table)
            ref = jax.jit(lambda x, t: sf._sparse_sums_sorted(x, t, cr, cr2, expert=expert))(
                x64, t64)
        check_vs_f64(P, f"N={N} table-driven kernel, {'expert' if expert else 'core'} "
                     "channels (XLA scan as the bound)", got, plain, ref)


# =============================================================================
# four cards
# =============================================================================


def phase_multi(S, ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as Pspec

    import gym_flock_tpu as gft
    from gym_flock_tpu.envs.flocking import FlockingParams
    from gym_flock_tpu.ops.pallas_flocking import _flocking_sums_xla, flocking_sums_block
    from gym_flock_tpu.parallel import (
        FlockingImitationTrainer,
        agent_sharded_rollout,
        batch_expert_rollout,
        make_env_mesh,
        make_flock_mesh,
    )
    from gym_flock_tpu.parallel.agent_shard import flocking_sums_sharded
    from gym_flock_tpu.parallel.train import collect_flocking_batch

    P = "multi"
    devs = jax.devices()
    assert len(devs) == 4, f"--multi needs 4 devices, found {len(devs)}"
    mesh = make_env_mesh("env", devs)

    def spread(arr, what):
        got = {s.device for s in arr.addressable_shards}
        rows = {s.data.shape[0] for s in arr.addressable_shards}
        log(f"[{P}] {what}: shards on {len(got)} devices, {sorted(rows)} rows each")
        assert got == set(devs) and len(rows) == 1, what

    # --- flagship rollout, env batch over the 4-device mesh
    env, params = gft.make("FlockingRelative-v0", n_agents=100)
    E, T = 4 * S["multi_flag_envs"], S["flag_steps"]
    key = jax.random.key(ctx["seed"])
    summary = lambda out: (out[0].x, out[1]["u"], out[1]["reward"])
    run4 = build(P, lambda k: summary(batch_expert_rollout(env, params, k, E, T, mesh=mesh)), key)
    x4, u4, r4 = run4(key)
    spread(x4, "flagship final states")
    run1 = build(P, lambda k: summary(batch_expert_rollout(env, params, k, E, T)), key)
    with jax.default_device(devs[0]):
        x1, u1, r1 = run1(key)
    check(P, f"flagship {E} envs: u at step 0, 4 cards vs 1", rel_err(u4[:, 0], u1[:, 0]), 1e-5)
    check(P, f"flagship {E} envs: rewards, 4 cards vs 1", rel_err(r4, r1), 1e-3)
    check(P, f"flagship {E} envs: final states, 4 cards vs 1",
          float(np.max(np.abs(np.asarray(x4) - np.asarray(x1)))), 1e-3)

    # --- dp=4 imitation step against the single-card step on the same batch
    trainer = FlockingImitationTrainer(env, params)
    carry = trainer.init(jax.random.key(ctx["seed"] + 1))
    E, T = S["multi_il_envs"], S["il_steps"]
    k_step = jax.random.key(ctx["seed"] + 2)
    step4, _ = trainer.make_sharded_train_step(mesh=mesh, n_envs=E, n_steps=T)
    (p4, _), loss4 = step4(carry, k_step)

    def single(carry, key):
        params_, opt = carry
        keys = jax.random.split(key, 4)  # what the sharded step hands each device

        def loss(p):
            per = [trainer.loss_fn(p, *collect_flocking_batch(env, params, k, E // 4, T))
                   for k in keys]
            return sum(per) / 4.0

        l, g = jax.value_and_grad(loss)(params_)
        upd, _ = trainer.tx.update(g, opt, params_)
        import optax

        return optax.apply_updates(params_, upd), l

    with jax.default_device(devs[0]):
        p1, loss1 = build(P, single, carry, k_step)(carry, k_step)
    check(P, "dp=4 train step loss vs one card", rel_err(loss4, loss1), 1e-4)
    # Adam's first step is lr * g / |g| elementwise: near-zero gradients
    # amplify summation-order noise, so the bound is half the 1e-3 step
    perr = max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(np.max(np.abs(np.asarray(a) - np.asarray(b)))), p4, p1)))
    check(P, "dp=4 train step params vs one card", perr, 5e-4)

    # --- agent-axis ring over 4 cards, FlockingLarge N=16,384
    N = S["multi_ring_n"]
    lparams = FlockingParams(n_agents=N, max_reset_tries=4)
    fmesh = make_flock_mesh(1, 4, devs)
    ring = build(P, lambda k: agent_sharded_rollout(lparams, k, n_envs=1, n_steps=4,
                                                    mesh=fmesh, mode="ring"), key)
    xs, mean_r = ring(key)
    spread(xs[0], f"ring rollout N={N} agents")
    assert bool(jnp.isfinite(mean_r))
    sums4 = build(P, jax.shard_map(
        lambda xl: flocking_sums_sharded(xl[0], lparams.comm_radius,
                                         lparams.comm_radius2, "ap", "ring")[None],
        mesh=fmesh, in_specs=Pspec("dp", "ap"), out_specs=Pspec("dp", "ap"),
    ), xs)(xs)
    x_one = jax.device_put(np.asarray(xs[0]), devs[0])
    dense = build(P, lambda x: flocking_sums_block(x, x, 0, 0, lparams.comm_radius,
                                                   lparams.comm_radius2), x_one)(x_one)
    with jax.enable_x64(True), jax.default_device(ctx["cpu"]):
        x64 = np.asarray(xs[0], np.float64)
        ref = jax.jit(lambda x: _flocking_sums_xla(
            x, x, 0, 0, lparams.comm_radius, lparams.comm_radius2, "full"))(x64)
    check_vs_f64(P, f"ring sums N={N} over 4 cards (dense sums on one card as the bound)",
                 np.asarray(sums4)[0], np.asarray(dense)[:, :12], np.asarray(ref)[:, :12])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-device paths")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU; prints no result line")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.multi:
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                       + " --xla_force_host_platform_device_count=4")

    sys.path.insert(0, str(HERE))
    import jax

    import gym_flock_tpu
    from gym_flock_tpu.utils.cache import enable_compile_cache

    if Path(gym_flock_tpu.__file__).resolve().parent.parent != HERE:
        raise SystemExit(f"gym_flock_tpu must come from {HERE}, "
                         f"not {gym_flock_tpu.__file__}")
    dev = jax.devices()[0]
    if not args.rehearse and dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform} ({dev.device_kind})")
    log(f"cache: {enable_compile_cache()}")
    if not args.rehearse:
        log(f"card (nvidia-smi name, power.limit): {card_info()}")
    log(f"jax {jax.__version__}; devices {len(jax.devices())} x {dev.device_kind}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")

    S = TINY if args.rehearse else FULL
    ctx = dict(seed=args.seed, cpu=jax.devices("cpu")[0], platform=dev.platform)
    phases = [phase_multi] if args.multi else [
        phase_flagship, phase_imitation, phase_coverage, phase_large, phase_sparse,
    ]
    t_all = time.perf_counter()
    for phase in phases:
        t0 = time.perf_counter()
        phase(S, ctx)
        log(f"== {phase.__name__} passed in {time.perf_counter() - t0:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    if args.rehearse:
        log("rehearsal passed (no result line off the card)")
        return
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    main()
