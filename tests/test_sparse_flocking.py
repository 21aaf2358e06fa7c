"""Block-sparse (cell-list) flocking reductions vs the dense kernel."""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest

from gym_flock_tpu.ops.pallas_flocking import flocking_sums
from gym_flock_tpu.ops.sparse_flocking import (
    block_pair_table,
    flocking_sums_sparse,
    morton_order,
)

CR, CR2 = 0.9, 0.81


def _swarm(key, n, spread):
    x = jax.random.normal(key, (n, 4), jnp.float32)
    return x.at[:, :2].mul(spread)


@pytest.mark.parametrize("n,spread", [(256, 4.0), (512, 8.0), (1024, 12.0)])
def test_sparse_matches_dense(n, spread):
    x = _swarm(jax.random.key(0), n, spread)
    want = flocking_sums(x, CR, CR2)[:, :9]
    got = flocking_sums_sparse(x, CR, CR2, k_max=16)[:, :9]
    scale = 1.0 + jnp.abs(want)
    assert float(jnp.max(jnp.abs(got - want) / scale)) < 1e-4


def test_sparse_batched_matches_dense():
    xs = jax.vmap(lambda k: _swarm(k, 256, 6.0))(jax.random.split(jax.random.key(1), 3))
    want = jax.vmap(lambda x: flocking_sums(x, CR, CR2))(xs)[:, :, :9]
    got = flocking_sums_sparse(xs, CR, CR2, k_max=16)[:, :, :9]
    scale = 1.0 + jnp.abs(want)
    assert float(jnp.max(jnp.abs(got - want) / scale)) < 1e-4


def test_overflow_falls_back_to_dense():
    """All agents in one spot: every block pair is in range -> capacity
    overflow -> dense fallback (answers still correct)."""
    x = jax.random.normal(jax.random.key(2), (512, 4), jnp.float32) * 0.01
    _, overflow = block_pair_table(x[morton_order(x, CR)], CR, k_max=2)
    assert bool(overflow)
    want = flocking_sums(x, CR, CR2)[:, :9]
    got = flocking_sums_sparse(x, CR, CR2, k_max=2)[:, :9]
    scale = 1.0 + jnp.abs(want)
    assert float(jnp.max(jnp.abs(got - want) / scale)) < 1e-4


def test_pruning_is_exact_not_lossy():
    """The bbox prune may only remove pairs with zero contribution: the
    degree channel (exact integer counts) must match the dense kernel
    EXACTLY, not just within tolerance."""
    x = _swarm(jax.random.key(3), 512, 6.0)
    want_deg = flocking_sums(x, CR, CR2)[:, 8]
    got_deg = flocking_sums_sparse(x, CR, CR2, k_max=16)[:, 8]
    np.testing.assert_array_equal(np.asarray(got_deg), np.asarray(want_deg))


def test_sparse_pallas_kernel_matches_xla_path():
    """The table-driven sparse pass == the dense fused pass on a batch (one
    batch-wide overflow predicate), for both channel sets; and the
    table-driven Triton kernel == the XLA scan it replaces on the GPU."""
    from gym_flock_tpu.ops.pallas_flocking import flocking_sums_block

    x = _swarm(jax.random.key(5), 512, 8.0)
    xb = jnp.stack([x, x[::-1]])
    want = flocking_sums_block(xb, xb, 0, 0, CR, CR2, channels="full")
    for channels, chans in (("core", list(range(9))), ("expert", [0, 3, 8, 10, 11])):
        got = flocking_sums_sparse(xb, CR, CR2, k_max=16, channels=channels)
        assert got.shape == (2, 512, 16)
        w = want[..., chans]
        err = jnp.abs(got[..., chans] - w) / (1.0 + jnp.abs(w))
        assert float(jnp.max(err)) < 1e-4, channels

    # the table-driven Triton kernel (interpret mode) == the XLA scan, on
    # a batch, both channel sets
    from gym_flock_tpu.ops.sparse_flocking import (
        _sparse_sums_sorted,
        _table_sums_triton,
        hilbert_order,
    )

    xs = jax.vmap(lambda xi: xi[hilbert_order(xi, CR)])(xb)
    table, overflow = jax.vmap(lambda a: block_pair_table(a, CR, 16))(xs)
    assert not bool(jnp.any(overflow))
    for expert in (False, True):
        want_s = jax.vmap(
            lambda a, t: _sparse_sums_sorted(a, t, CR, CR2, expert=expert)
        )(xs, table)
        got_s = _table_sums_triton(xs, table, CR, CR2, expert, interpret=True)
        err = jnp.abs(got_s - want_s) / (1.0 + jnp.abs(want_s))
        assert float(jnp.max(err)) < 1e-4, expert

def test_sparse_env_matches_large_env():
    """FlockingSparse-v0 == FlockingLarge-v0: obs, expert, reward over a
    short rollout from the same reset."""
    import gym_flock_tpu as gft

    env_s, params = gft.make("FlockingSparse-v0", n_agents=256, max_reset_tries=4)
    env_l, _ = gft.make("FlockingLarge-v0", n_agents=256, max_reset_tries=4)

    key = jax.random.key(0)
    state_s, obs_s = env_s.reset_env(key, params)
    state_l, obs_l = env_l.reset_env(key, params)
    np.testing.assert_array_equal(np.asarray(state_s.x), np.asarray(state_l.x))
    for t in range(3):
        u_s = env_s.controller(state_s, params)
        u_l = env_l.controller(state_l, params)
        np.testing.assert_allclose(np.asarray(u_s), np.asarray(u_l), atol=1e-4)
        kt = jax.random.key(t + 1)
        state_s, (vals_s, deg_s), r_s, _, _ = env_s.step_env(kt, state_s, u_s, params)
        state_l, (vals_l, deg_l), r_l, _, _ = env_l.step_env(kt, state_l, u_l, params)
        scale = 1.0 + np.abs(np.asarray(vals_l))
        assert float(np.max(np.abs(np.asarray(vals_s) - np.asarray(vals_l)) / scale)) < 1e-4
        np.testing.assert_array_equal(np.asarray(deg_s), np.asarray(deg_l))
        np.testing.assert_allclose(float(r_s), float(r_l), rtol=1e-5)


def test_sparse_adjacency_matmul_matches_dense_and_differentiates():
    """Sparse (A@H) == dense adjacency_matmul, forward AND gradient."""
    from gym_flock_tpu.ops.pallas_flocking import adjacency_matmul
    from gym_flock_tpu.ops.sparse_flocking import adjacency_matmul_sparse

    kx, kh, kc = jax.random.split(jax.random.key(9), 3)
    x = _swarm(kx, 512, 8.0)
    h = jax.random.normal(kh, (512, 6), jnp.float32)
    co = jax.random.normal(kc, (512, 6), jnp.float32)

    for mean_pool in (False, True):
        want = adjacency_matmul(x, h, CR2, mean_pool=mean_pool)
        got = adjacency_matmul_sparse(x, h, CR2, mean_pool=mean_pool)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-4)

        want_g = jax.grad(
            lambda hv: jnp.sum(
                adjacency_matmul(x, hv, CR2, mean_pool=mean_pool) * co
            )
        )(h)
        got_g = jax.grad(
            lambda hv: jnp.sum(
                adjacency_matmul_sparse(x, hv, CR2, mean_pool=mean_pool) * co
            )
        )(h)
        np.testing.assert_allclose(np.asarray(got_g), np.asarray(want_g), atol=2e-4)


def test_sparse_khop_in_large_gnn_trains():
    """LargeAggregationGNN with the sparse aggregate_fn produces the same
    forward as the dense module and trains (params move)."""
    import functools

    from gym_flock_tpu.models import LargeAggregationGNN
    from gym_flock_tpu.ops.sparse_flocking import khop_aggregate_sparse

    kx, kh = jax.random.split(jax.random.key(10))
    x = _swarm(kx, 256, 6.0)
    feats = jax.random.normal(kh, (256, 6), jnp.float32)

    dense = LargeAggregationGNN(comm_radius2=CR2)
    sparse = LargeAggregationGNN(
        comm_radius2=CR2,
        aggregate_fn=functools.partial(khop_aggregate_sparse, comm_radius2=CR2, k_hops=3),
    )
    params = dense.init(jax.random.key(0), x, feats)
    out_d = dense.apply(params, x, feats)
    out_s = sparse.apply(params, x, feats)
    np.testing.assert_allclose(np.asarray(out_s), np.asarray(out_d), atol=2e-4)

    g = jax.grad(lambda p: jnp.sum(sparse.apply(p, x, feats) ** 2))(params)
    assert max(float(np.abs(np.asarray(l)).max()) for l in jax.tree.leaves(g)) > 0


def test_sparse_reset_accept_matches_dense():
    """sparse_reset_accept == the dense acceptance test, bit-for-bit
    (degree counts are integers and per-pair r2 floats are identical), on
    spread swarms, near-threshold swarms, and a clustered overflow draw."""
    from gym_flock_tpu.ops.sparse_flocking import sparse_reset_accept

    def dense_accept(x, thresh):
        px, py = x[:, 0], x[:, 1]
        dx = px[:, None] - px[None, :]
        dy = py[:, None] - py[None, :]
        r2 = dx * dx + dy * dy
        n = x.shape[0]
        r2 = jnp.where(jnp.eye(n, dtype=bool), jnp.inf, r2)
        deg = jnp.min(jnp.sum(r2 < CR2, axis=1))
        return (deg >= 2) & (jnp.sqrt(jnp.min(r2)) > thresh)

    cases = [
        _swarm(jax.random.key(11), 256, 4.0),   # typical accept-ish
        _swarm(jax.random.key(12), 512, 50.0),  # sparse -> low degree reject
        _swarm(jax.random.key(13), 256, 0.02),  # clustered -> overflow path
    ]
    for thresh in (0.1, 0.5):
        for x in cases:
            want = bool(dense_accept(x, thresh))
            got = bool(sparse_reset_accept(x, CR, CR2, thresh))
            assert got == want, (thresh, float(jnp.min(jnp.abs(x))))


@pytest.mark.slow  # vmap routing also covered by test_sparse_adjacency_matmul_vmap_shared_operand
def test_sparse_adjacency_matmul_vmap_routes_to_native_batch():
    """jax.vmap of the unbatched form must equal per-element calls (the
    custom_vmap rule reshapes into the native [B, N, *] batch so the
    overflow fallback stays a real scalar branch)."""
    from gym_flock_tpu.ops.sparse_flocking import adjacency_matmul_sparse

    keys = jax.random.split(jax.random.key(21), 3)
    xs = jax.vmap(lambda k: _swarm(k, 256, 6.0))(keys)
    hs = jax.random.normal(jax.random.key(22), (3, 256, 5), jnp.float32)

    got = jax.vmap(
        lambda x, h: adjacency_matmul_sparse(x, h, CR2, mean_pool=True)
    )(xs, hs)
    want = jnp.stack(
        [adjacency_matmul_sparse(xs[i], hs[i], CR2, mean_pool=True) for i in range(3)]
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)

    # gradient flows through the vmapped form too
    g = jax.grad(
        lambda hv: jnp.sum(
            jax.vmap(lambda x, h: adjacency_matmul_sparse(x, h, CR2))(xs, hv)
        )
    )(hs)
    assert np.all(np.isfinite(np.asarray(g)))


def test_sparse_decentralized_expert_matches_dense():
    """FlockingSparse centralized=False: the adjacency-masked expert
    channels (10/11) reproduce the dense decentralized Turner controller."""
    import gym_flock_tpu as gft
    from gym_flock_tpu.envs.flocking import turner_controller

    env, params = gft.make("FlockingSparse-v0", n_agents=256, max_reset_tries=4)
    state, _ = env.reset_env(jax.random.key(3), params)

    want = turner_controller(state.x, params, centralized=False)
    got = env.controller(state, params, centralized=False)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)

    # fused rollout runs decentralized too and tracks the dense env
    env_l, _ = gft.make("FlockingLarge-v0", n_agents=256, max_reset_tries=4)
    fin_s, _ = env.expert_rollout(state, params, n_steps=3, centralized=False)
    fin_l, _ = env_l.expert_rollout(state, params, n_steps=3, centralized=False)
    np.testing.assert_allclose(
        np.asarray(fin_s.x), np.asarray(fin_l.x), atol=1e-4
    )


def test_sparse_expert_channels_match_dense_full():
    """channels="expert" sums 10/11 == the dense full-channel kernel."""
    from gym_flock_tpu.ops.pallas_flocking import flocking_sums_block

    x = _swarm(jax.random.key(31), 512, 8.0)
    want = flocking_sums_block(x, x, 0, 0, CR, CR2, channels="full")
    got = flocking_sums_sparse(x, CR, CR2, channels="expert")
    scale = 1.0 + jnp.abs(want)
    for ch in (10, 11):
        assert float(jnp.max(jnp.abs(got[:, ch] - want[:, ch]) / scale[:, ch])) < 1e-4


def test_sparse_reset_accept_vmap_and_batched():
    """vmap of the unbatched accept == per-env results, and the batched
    [B, N, 4] form matches too (custom_vmap keeps the overflow fallback a
    scalar branch on the batched reset path)."""
    from gym_flock_tpu.ops.sparse_flocking import sparse_reset_accept

    xs = jax.vmap(lambda k: _swarm(k, 256, 5.0))(
        jax.random.split(jax.random.key(41), 4)
    )
    per_env = [bool(sparse_reset_accept(xs[i], CR, CR2, 0.1)) for i in range(4)]
    got_v = jax.vmap(lambda x: sparse_reset_accept(x, CR, CR2, 0.1))(xs)
    got_b = sparse_reset_accept(xs, CR, CR2, 0.1)
    assert [bool(v) for v in got_v] == per_env
    assert [bool(v) for v in got_b] == per_env


def test_sparse_adjacency_matmul_vmap_shared_operand():
    """vmap with one shared (unbatched) operand broadcasts instead of
    failing: a batch of swarms with shared features and vice versa."""
    from gym_flock_tpu.ops.sparse_flocking import adjacency_matmul_sparse

    xs = jax.vmap(lambda k: _swarm(k, 256, 6.0))(
        jax.random.split(jax.random.key(43), 3)
    )
    h = jax.random.normal(jax.random.key(44), (256, 5), jnp.float32)

    got = jax.vmap(lambda x: adjacency_matmul_sparse(x, h, CR2))(xs)
    want = jnp.stack(
        [adjacency_matmul_sparse(xs[i], h, CR2) for i in range(3)]
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)

    x0 = xs[0]
    hs = jax.random.normal(jax.random.key(45), (3, 256, 5), jnp.float32)
    got2 = jax.vmap(lambda hv: adjacency_matmul_sparse(x0, hv, CR2))(hs)
    want2 = jnp.stack(
        [adjacency_matmul_sparse(x0, hs[i], CR2) for i in range(3)]
    )
    np.testing.assert_allclose(np.asarray(got2), np.asarray(want2), atol=1e-5)


# =============================================================================
# Verlet (cross-call) candidate tables
# =============================================================================


def test_verlet_pass_matches_fresh_within_slack():
    """With every agent within skin/2 of the anchor, the REUSED table must
    reproduce a fresh-built sparse pass: degree exactly, sums to float
    summation-order tolerance (the stale permutation groups pairs
    differently)."""
    from gym_flock_tpu.ops.sparse_flocking import (
        flocking_sums_sparse_verlet,
        verlet_build,
    )

    skin = CR
    x0 = _swarm(jax.random.key(50), 512, 8.0)
    vs0 = verlet_build(x0, CR, skin, k_max=16)

    # move every agent by strictly less than skin/2 (worst case allowed)
    step = jax.random.normal(jax.random.key(51), (512, 2), jnp.float32)
    step = step / jnp.linalg.norm(step, axis=1, keepdims=True) * (0.49 * skin)
    x1 = x0.at[:, :2].add(step)

    got, vs1 = flocking_sums_sparse_verlet(x1, vs0, CR, CR2, skin)
    # no rebuild happened: the anchor is still x0's
    np.testing.assert_array_equal(np.asarray(vs1.anchor), np.asarray(x0[:, :2]))

    want = flocking_sums_sparse(x1, CR, CR2, k_max=16)
    np.testing.assert_array_equal(np.asarray(got[:, 8]), np.asarray(want[:, 8]))
    scale = 1.0 + np.abs(np.asarray(want[:, :9]))
    assert float(np.max(np.abs(np.asarray(got[:, :9] - want[:, :9])) / scale)) < 1e-4


def test_verlet_rebuild_triggers_beyond_slack():
    """One agent moving past skin/2 forces a rebuild: the anchor updates
    and the result still matches a fresh pass."""
    from gym_flock_tpu.ops.sparse_flocking import (
        flocking_sums_sparse_verlet,
        verlet_build,
    )

    skin = CR
    x0 = _swarm(jax.random.key(52), 256, 6.0)
    vs0 = verlet_build(x0, CR, skin, k_max=16)
    x1 = x0.at[0, 0].add(0.51 * skin)

    got, vs1 = flocking_sums_sparse_verlet(x1, vs0, CR, CR2, skin)
    np.testing.assert_array_equal(np.asarray(vs1.anchor), np.asarray(x1[:, :2]))
    want = flocking_sums_sparse(x1, CR, CR2, k_max=16)
    np.testing.assert_array_equal(np.asarray(got[:, 8]), np.asarray(want[:, 8]))
    scale = 1.0 + np.abs(np.asarray(want[:, :9]))
    assert float(np.max(np.abs(np.asarray(got[:, :9] - want[:, :9])) / scale)) < 1e-4


def test_verlet_overflow_falls_back_to_dense():
    """A clustered swarm overflowing the verlet table must fall back to the
    dense kernel (answers correct, never wrong)."""
    from gym_flock_tpu.ops.sparse_flocking import (
        flocking_sums_sparse_verlet,
        verlet_build,
    )

    x = jax.random.normal(jax.random.key(53), (512, 4), jnp.float32) * 0.01
    vs = verlet_build(x, CR, CR, k_max=2)
    assert bool(vs.overflow)
    got, _ = flocking_sums_sparse_verlet(x, vs, CR, CR2, CR)
    want = flocking_sums(x, CR, CR2)[:, :9]
    scale = 1.0 + np.abs(np.asarray(want))
    assert float(np.max(np.abs(np.asarray(got[:, :9]) - np.asarray(want)) / scale)) < 1e-4


@pytest.mark.parametrize("dt,centralized", [(0.01, True), (0.6, True), (0.01, False)])
def test_verlet_rollout_matches_every_step_rebuild(dt, centralized):
    """SparseFlockingEnv.expert_rollout with the Verlet table == the base
    every-step-rebuild rollout.  dt=0.01 exercises pure REUSE (no agent
    crosses skin/2 in 12 steps); dt=0.6 forces rebuilds nearly every step;
    the decentralized case routes the expert through channels 10/11."""
    import gym_flock_tpu as gft

    env, params = gft.make(
        "FlockingSparse-v0", n_agents=256, max_reset_tries=4, dt=dt,
        centralized=centralized,
    )
    key = jax.random.key(7)
    state, _ = env.reset_env(key, params)

    base_params = params.replace(verlet_skin=0.0)  # every-step rebuild path
    f_v, traj_v = env.expert_rollout(state, params, n_steps=12, key=key)
    f_b, traj_b = env.expert_rollout(state, base_params, n_steps=12, key=key)

    np.testing.assert_array_equal(
        np.asarray(traj_v["network"]), np.asarray(traj_b["network"])
    )
    for k in ("u", "values", "reward"):
        a, b = np.asarray(traj_v[k]), np.asarray(traj_b[k])
        scale = 1.0 + np.abs(b)
        assert float(np.max(np.abs(a - b) / scale)) < 1e-4, k
    scale = 1.0 + np.abs(np.asarray(f_b.x))
    assert float(np.max(np.abs(np.asarray(f_v.x) - np.asarray(f_b.x)) / scale)) < 1e-4


def test_verlet_pass_vmap_routes_native_batch():
    """jax.vmap of the unbatched verlet pass must route to the native
    batched impl (custom_vmap): results match per-env calls, and the
    returned state stays per-env."""
    from gym_flock_tpu.ops.sparse_flocking import (
        flocking_sums_sparse_verlet,
        verlet_build,
    )

    skin = CR
    xs = jax.vmap(lambda k: _swarm(k, 256, 6.0))(
        jax.random.split(jax.random.key(60), 2)
    )
    vss = jax.vmap(lambda x: verlet_build(x, CR, skin, k_max=16))(xs)

    got, vs1 = jax.vmap(
        lambda x, vs: flocking_sums_sparse_verlet(x, vs, CR, CR2, skin)
    )(xs, vss)
    assert got.shape == (2, 256, 16)
    assert vs1.perm.shape == (2, 256)

    for i in range(2):
        want_i, _ = flocking_sums_sparse_verlet(
            xs[i], jax.tree.map(lambda l: l[i], vss), CR, CR2, skin
        )
        np.testing.assert_array_equal(
            np.asarray(got[i, :, 8]), np.asarray(want_i[:, 8])
        )
        scale = 1.0 + np.abs(np.asarray(want_i[:, :9]))
        assert (
            float(
                np.max(np.abs(np.asarray(got[i, :, :9] - want_i[:, :9])) / scale)
            )
            < 1e-4
        )


@pytest.mark.slow  # batch variant; verlet semantics covered by test_verlet_rollout_matches_every_step_rebuild
def test_batch_expert_rollout_sparse_verlet():
    """parallel.batch_expert_rollout over the sparse env with the Verlet
    table enabled (the review's headline regression: the unprotected pass
    select-executed the dense fallback and re-sorted per step per lane)."""
    import gym_flock_tpu as gft
    from gym_flock_tpu.parallel import batch_expert_rollout

    env, params = gft.make("FlockingSparse-v0", n_agents=128, max_reset_tries=4)
    key = jax.random.key(8)
    finals, traj = batch_expert_rollout(env, params, key, n_envs=2, n_steps=3)
    assert traj["u"].shape == (2, 3, 128, 2)

    # matches per-env rollouts (identical key split as batch_expert_rollout)
    keys = jax.random.split(key, 2)
    for i in range(2):
        k_reset, k_roll = jax.random.split(keys[i])
        state, _ = env.reset_env(k_reset, params)
        _, traj_i = env.expert_rollout(state, params, 3, key=k_roll)
        a, b = np.asarray(traj["u"][i]), np.asarray(traj_i["u"])
        scale = 1.0 + np.abs(b)
        assert float(np.max(np.abs(a - b) / scale)) < 1e-4


@pytest.mark.slow  # re-jit/tracing robustness variant of the sparse rollout
def test_sparse_expert_rollout_params_traced():
    """params may be a traced jit argument: the verlet gating branches only
    on STATIC fields (the old code crashed at `if skin <= 0.0` with the
    dynamic comm_radius resolved as the skin)."""
    import gym_flock_tpu as gft

    env, params = gft.make("FlockingSparse-v0", n_agents=128, max_reset_tries=4)
    state, _ = env.reset_env(jax.random.key(9), params)

    f = jax.jit(lambda s, p: env.expert_rollout(s, p, 3))
    final, traj = f(state, params)
    assert traj["u"].shape == (3, 128, 2)


@pytest.mark.slow  # batch variant; verlet rebuild semantics covered by test_verlet_rollout_matches_every_step_rebuild[0.6-True]
def test_batch_expert_rollout_verlet_rebuilds():
    """The BATCH-wide rebuild branch inside the custom_vmap-routed impl:
    dt=0.6 drifts agents past skin/2 nearly every step, so the batched
    rollout exercises 'one drifted env rebuilds the whole batch' (B=2) —
    the other batched tests never leave pure reuse.  Ground truth is the
    per-env every-step-rebuild rollout (verlet_skin=0)."""
    import gym_flock_tpu as gft
    from gym_flock_tpu.parallel import batch_expert_rollout

    env, params = gft.make(
        "FlockingSparse-v0", n_agents=128, max_reset_tries=4, dt=0.6
    )
    key = jax.random.key(11)
    finals, traj = batch_expert_rollout(env, params, key, n_envs=2, n_steps=8)

    base_params = params.replace(verlet_skin=0.0)
    keys = jax.random.split(key, 2)
    for i in range(2):
        k_reset, k_roll = jax.random.split(keys[i])
        state, _ = env.reset_env(k_reset, base_params)
        _, traj_i = env.expert_rollout(state, base_params, 8, key=k_roll)
        for k in ("u", "values", "reward"):
            a, b = np.asarray(traj[k][i]), np.asarray(traj_i[k])
            scale = 1.0 + np.abs(b)
            assert float(np.max(np.abs(a - b) / scale)) < 1e-4, k


def test_sparse_adj_bf16_h_cpu_branch_dtypes():
    """adjacency_matmul_sparse with a bf16 H on the host backend: the
    sparse/dense cond branches must produce identical avals (deg was
    bf16 on the sparse path and f32 on the dense fallback — a trace-time
    TypeError)."""
    from gym_flock_tpu.ops.sparse_flocking import adjacency_matmul_sparse

    x = _swarm(jax.random.key(70), 256, 8.0)
    h = jax.random.normal(jax.random.key(71), (256, 8), jnp.bfloat16)
    out = adjacency_matmul_sparse(x, h, CR2)
    assert out.dtype == jnp.bfloat16 and out.shape == (256, 8)
    # grad path too (the custom VJP reruns the same kernel on dy)
    g = jax.grad(lambda hh: jnp.sum(
        adjacency_matmul_sparse(x, hh, CR2).astype(jnp.float32)))(h)
    assert g.shape == h.shape


def test_sparse_channels_vocabulary_validated():
    """The dense kernels' channels='full' must raise, not silently zero
    the masked-grad channels."""
    from gym_flock_tpu.ops.sparse_flocking import flocking_sums_sparse

    x = _swarm(jax.random.key(72), 256, 8.0)
    with pytest.raises(ValueError, match="core.*expert"):
        flocking_sums_sparse(x, CR, CR2, channels="full")
