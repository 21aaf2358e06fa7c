"""Large-N pairwise passes (ops.pallas_flocking) and the coverage expert's
greedy row-min against plain references: float64 NumPy oracles, the dense
env kernels, and dense autodiff.  The Triton adjacency kernel runs in
interpret mode here; on a GPU it is compiled (``gpu``-marked tests and
chip_smoke.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gym_flock_tpu.envs.flocking import (
    FlockingParams,
    flocking_features,
    turner_controller,
    mean_pool_normalize,
)
from gym_flock_tpu.ops import pallas_flocking as pf
from gym_flock_tpu.ops.pallas_flocking import (
    adjacency_matmul,
    flocking_sums,
    khop_aggregate,
    turner_controller_large,
)

CR, CR2 = 0.9, 0.81


def _sums_oracle(xr, xc, roff, coff, cr=CR, cr2=CR2):
    """float64 NumPy channel sums (ops.pallas_flocking layout, 0..11)."""
    xr = np.asarray(xr, np.float64)
    xc = np.asarray(xc, np.float64)
    dx = xr[:, None, 0] - xc[None, :, 0]
    dy = xr[:, None, 1] - xc[None, :, 1]
    dvx = xr[:, None, 2] - xc[None, :, 2]
    dvy = xr[:, None, 3] - xc[None, :, 3]
    r2 = dx * dx + dy * dy
    ids_r = roff + np.arange(len(xr))
    ids_c = coff + np.arange(len(xc))
    r2 = np.where(ids_r[:, None] == ids_c[None, :], np.inf, r2)
    adj = (r2 < cr2).astype(np.float64)
    with np.errstate(divide="ignore"):
        inv = 1.0 / r2
    gfac = np.where(r2 > cr, 0.0, 2.0 * inv * (1.0 - inv))
    return np.stack(
        [
            (dvx * adj).sum(1), (dx * inv * inv * adj).sum(1), (dx * inv * adj).sum(1),
            (dvy * adj).sum(1), (dy * inv * inv * adj).sum(1), (dy * inv * adj).sum(1),
            (dx * gfac).sum(1), (dy * gfac).sum(1), adj.sum(1), r2.min(1),
            (dx * gfac * adj).sum(1), (dy * gfac * adj).sum(1),
        ],
        axis=1,
    )


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))


def _adj_oracle(x, h, cr2=CR2, mean_pool=False):
    x = np.asarray(x, np.float64)
    d = x[:, None, :2] - x[None, :, :2]
    r2 = (d * d).sum(-1)
    adj = ((r2 < cr2) & ~np.eye(len(x), dtype=bool)).astype(np.float64)
    out = adj @ np.asarray(h, np.float64)
    if mean_pool:
        deg = adj.sum(1, keepdims=True)
        out = out / np.where(deg == 0, 1.0, deg)
    return out


def _swarm(seed, n, scale=2.0):
    return jnp.asarray(np.random.RandomState(seed).randn(n, 4).astype(np.float32) * scale)


@pytest.mark.parametrize("n", [64, 137, 200])
def test_flocking_sums_matches_xla(n):
    """Core channel sums == the float64 oracle; 9..15 are zero."""
    x = _swarm(0, n)
    s = flocking_sums(x, CR, CR2)
    want = _sums_oracle(x, x, 0, 0)
    assert _rel_err(s[:, :9], want[:, :9]) < 1e-4
    np.testing.assert_array_equal(np.asarray(s[:, 8]), want[:, 8])
    assert not np.any(np.asarray(s[:, 9:]))


@pytest.mark.parametrize("centralized", [True, False])
def test_pallas_controller_matches_xla(centralized):
    n = 150
    x = _swarm(1, n)
    params = FlockingParams(n_agents=n)
    u_ref = turner_controller(x, params, centralized=centralized)
    u_large = turner_controller_large(
        x, params.comm_radius, params.comm_radius2, params.action_scalar,
        centralized=centralized,
    )
    np.testing.assert_allclose(np.asarray(u_large), np.asarray(u_ref), atol=1e-4)


@pytest.mark.parametrize("mean_pool", [True, False])
def test_adjacency_matmul_matches_xla(mean_pool):
    """The Triton kernel (interpret mode) == the XLA product == the oracle,
    with N and F not multiples of the kernel's tiles."""
    n, f = 200, 6
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(n, 4).astype(np.float32) * 2)
    h = jnp.asarray(rng.randn(n, f).astype(np.float32))
    zero = jnp.zeros((2,), jnp.int32)
    out_k, deg_k = pf._adj_matmul_triton(x, x, h, zero, CR2, interpret=True)
    out_x, deg_x = pf._adj_matmul_xla(x, x, h, zero, CR2)
    np.testing.assert_array_equal(np.asarray(deg_k), np.asarray(deg_x))
    if mean_pool:
        out_k = out_k / jnp.where(deg_k == 0, 1.0, deg_k)[:, None]
    want = _adj_oracle(x, h, mean_pool=mean_pool)
    np.testing.assert_allclose(np.asarray(out_k), want, atol=2e-5, rtol=1e-5)
    got = adjacency_matmul(x, h, CR2, mean_pool=mean_pool)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5, rtol=1e-5)
    dense = mean_pool_normalize(flocking_features(x, CR2)[1]) if mean_pool else None
    if dense is not None:
        np.testing.assert_allclose(np.asarray(got), np.asarray(dense @ h), atol=2e-4)


def test_khop_aggregate_shapes():
    n, f = 100, 6
    x = _swarm(3, n, 1.0)
    feats = jnp.asarray(np.random.RandomState(4).randn(n, f).astype(np.float32))
    z = khop_aggregate(x, feats, CR2, k_hops=3)
    assert z.shape == (n, 3 * f)


def test_large_flocking_env_matches_reference_env_semantics():
    """LargeFlockingEnv's features/expert equal the dense-path env."""
    import gym_flock_tpu as gft
    from gym_flock_tpu.ops.pallas_flocking import flocking_features_large

    env_l, params = gft.make("FlockingLarge-v0", n_agents=96)
    x = _swarm(0, 96)

    vals, deg = flocking_features_large(x, params.comm_radius, params.comm_radius2)
    want_vals, adj, _, _ = flocking_features(x, params.comm_radius2)
    np.testing.assert_allclose(np.asarray(vals), np.asarray(want_vals), atol=2e-4)
    np.testing.assert_array_equal(np.asarray(deg), np.asarray(jnp.sum(adj, axis=1)))
    u = turner_controller_large(x, params.comm_radius, params.comm_radius2,
                                params.action_scalar)
    np.testing.assert_allclose(np.asarray(u), np.asarray(turner_controller(x, params)),
                               atol=1e-4)
    s = env_l.init_state(x, params)
    np.testing.assert_allclose(np.asarray(env_l.expert(s, params)), np.asarray(u))


def test_flocking_sums_batched_equals_per_env():
    from gym_flock_tpu.ops.pallas_flocking import flocking_sums_batched

    xs = jnp.asarray(np.random.RandomState(7).randn(3, 80, 4).astype(np.float32) * 2)
    out_b = flocking_sums_batched(xs, CR, CR2)
    for i in range(3):
        want = np.asarray(flocking_sums(xs[i], CR, CR2))
        assert _rel_err(out_b[i], want) < 1e-5, f"env {i}"


def test_flocking_sums_vmap_routes_to_native_batch():
    """jax.vmap of flocking_sums == per-env calls == the oracle."""
    xs = jnp.asarray(np.random.RandomState(9).randn(4, 64, 4).astype(np.float32) * 2)
    got = jax.vmap(lambda x: flocking_sums(x, CR, CR2))(xs)
    for i in range(4):
        assert _rel_err(got[i, :, :9], _sums_oracle(xs[i], xs[i], 0, 0)[:, :9]) < 1e-4


@pytest.mark.parametrize("n", [300, 260, 383])
def test_flocking_sums_row_coverage_regression(n):
    """Every row is computed and finite at sizes off any power of two."""
    x = _swarm(0, n)
    s = flocking_sums(x, CR, CR2)
    assert bool(jnp.isfinite(s).all()), "non-finite output rows"
    values, adj, _, _ = flocking_features(x, CR2)
    assert _rel_err(s[:, :6], values) < 1e-4


def test_adjacency_matmul_row_coverage_regression():
    """Kernel rows past the last full row block are computed and finite."""
    n, f = 300, 16
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(n, 4).astype(np.float32) * 2)
    h = jnp.asarray(rng.randn(n, f).astype(np.float32))
    out, deg = pf._adj_matmul_triton(x, x, h, jnp.zeros((2,), jnp.int32), CR2,
                                     interpret=True)
    assert bool(jnp.isfinite(out).all())
    np.testing.assert_allclose(np.asarray(out), _adj_oracle(x, h), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("m,k,roff,coff", [(64, 64, 0, 64), (40, 100, 80, 0), (128, 128, 128, 128)])
def test_flocking_sums_block_matches_tiled_dense(m, k, roff, coff):
    """Cross-block sums equal the same rows/cols of the float64 oracle
    (global-id offsets decide the self-pair mask)."""
    from gym_flock_tpu.ops.pallas_flocking import flocking_sums_block

    n = max(roff + m, coff + k)
    x = jnp.asarray(np.random.RandomState(11).randn(n, 4).astype(np.float32) * 2)
    xr, xc = x[roff : roff + m], x[coff : coff + k]
    want = _sums_oracle(xr, xc, roff, coff)
    got = flocking_sums_block(xr, xc, roff, coff, CR, CR2)
    assert _rel_err(got[:, :12], want) < 1e-4
    assert not np.any(np.asarray(got[:, 12:]))


def test_flocking_sums_block_tiling_covers_full_swarm():
    """Accumulating block tiles over all column blocks == flocking_sums."""
    from gym_flock_tpu.ops.pallas_flocking import flocking_sums_block

    n, m = 96, 24
    x = jnp.asarray(np.random.RandomState(13).randn(n, 4).astype(np.float32) * 2)
    want = flocking_sums(x, CR, CR2)

    for roff in range(0, n, m):
        acc = None
        for coff in range(0, n, m):
            part = flocking_sums_block(
                x[roff : roff + m], x[coff : coff + m], roff, coff, CR, CR2
            )
            if acc is None:
                acc = part
            else:
                merged = acc + part
                acc = merged.at[:, 9].set(jnp.minimum(acc[:, 9], part[:, 9]))
        assert _rel_err(acc[:, :9], want[roff : roff + m, :9]) < 1e-4, roff


def test_flocking_sums_block_padding_is_nan_free():
    """No NaN anywhere under jax_debug_nans: the block sums' self-pair
    mask (r2 = inf) and the kernel's padding (row pads and column pads
    parked on offset ladders that never coincide)."""
    from gym_flock_tpu.ops.pallas_flocking import flocking_sums_block

    x = jnp.asarray(np.random.RandomState(17).randn(128, 4).astype(np.float32) * 2)
    h = jnp.ones((64, 8), jnp.float32)
    with jax.debug_nans(True):
        out = flocking_sums_block(x[:64], x[64:128], 0, 64, CR, CR2)
        out_k, deg_k = pf._adj_matmul_triton(
            x[:50], x[64:114], h[:50], jnp.asarray([0, 64], jnp.int32), CR2,
            interpret=True,
        )
    assert bool(jnp.isfinite(out).all())
    assert bool(jnp.isfinite(out_k).all()) and bool(jnp.isfinite(deg_k).all())


def test_adjacency_matmul_block_tiling_covers_full():
    """Summing (out, deg) tiles over all column blocks == adjacency_matmul."""
    from gym_flock_tpu.ops.pallas_flocking import adjacency_matmul_block

    n, m, f = 96, 32, 8
    rng = np.random.RandomState(21)
    x = jnp.asarray(rng.randn(n, 4).astype(np.float32) * 2)
    h = jnp.asarray(rng.randn(n, f).astype(np.float32))
    want = adjacency_matmul(x, h, CR2, mean_pool=False)

    for roff in range(0, n, m):
        acc = deg = None
        for coff in range(0, n, m):
            o, d = adjacency_matmul_block(
                x[roff : roff + m], x[coff : coff + m], h[coff : coff + m],
                roff, coff, CR2,
            )
            acc = o if acc is None else acc + o
            deg = d if deg is None else deg + d
        np.testing.assert_allclose(
            np.asarray(acc), np.asarray(want[roff : roff + m]), atol=2e-5
        )


@pytest.mark.parametrize("n", [64, 137, 200])
def test_flocking_sums_xla_impl_matches_pallas(n):
    """The full channel set (min-r2 and masked gradient sums) == the
    float64 oracle, and batched leading dims are native."""
    from gym_flock_tpu.ops.pallas_flocking import _flocking_sums_xla

    x = _swarm(1, n)
    want = _sums_oracle(x, x, 0, 0)
    got_f = _flocking_sums_xla(x, x, 0, 0, CR, CR2, channels="full")
    assert _rel_err(got_f[:, :12], want) < 1e-4

    got = flocking_sums(x, CR, CR2)
    xb = jnp.stack([x, x[::-1]])
    got_b = flocking_sums(xb, CR, CR2)
    assert got_b.shape == (2, n, 16)
    assert _rel_err(got_b[0], got) < 1e-6


def test_adjacency_matmul_grad_matches_dense(triton_adj_tile):
    """custom-VJP gradients == autodiff of the dense formulation, with the
    adjacency tile run by the Triton kernel (interpret mode)."""
    n, f = 48, 5
    rs = np.random.RandomState(7)
    x = jnp.asarray(rs.randn(n, 4).astype(np.float32))
    h = jnp.asarray(rs.randn(n, f).astype(np.float32))
    zero = jnp.zeros((2,), jnp.int32)
    cr2 = jnp.float32(CR2)

    def dense(xv, hv, mean_pool):
        d = xv[:, None, :2] - xv[None, :, :2]
        r2 = jnp.sum(d * d, axis=-1)
        r2 = jnp.where(jnp.eye(n, dtype=bool), jnp.inf, r2)
        adj = (r2 < CR2).astype(jnp.float32)
        out = jnp.matmul(adj, hv, precision=jax.lax.Precision.HIGHEST)
        if mean_pool:
            deg = jnp.sum(adj, axis=1, keepdims=True)
            out = out / jnp.where(deg == 0, 1.0, deg)
        return out

    def kernel(xv, hv, mean_pool):
        out, deg = pf._adj_block(xv, xv, hv, zero, cr2)
        if mean_pool:
            out = out / jnp.where(deg == 0, 1.0, deg)[:, None]
        return out

    for mean_pool in (False, True):
        np.testing.assert_allclose(
            np.asarray(kernel(x, h, mean_pool)), np.asarray(dense(x, h, mean_pool)),
            atol=2e-5,
        )
        co = jnp.asarray(rs.randn(n, f).astype(np.float32))
        want_gh = jax.grad(lambda hv: jnp.sum(dense(x, hv, mean_pool) * co))(h)
        got_gh = jax.grad(lambda hv: jnp.sum(kernel(x, hv, mean_pool) * co))(h)
        np.testing.assert_allclose(np.asarray(got_gh), np.asarray(want_gh), atol=2e-5)

        # positions: zero cotangent (a.e.-correct for the step-function adj)
        got_gx = jax.grad(lambda xv: jnp.sum(kernel(xv, h, mean_pool)))(x)
        assert float(jnp.max(jnp.abs(got_gx))) == 0.0


def test_adjacency_kernel_batched_and_vmapped():
    """Leading batch dims and jax.vmap both reach the kernel's env grid
    axis and agree with the XLA product env by env, across offsets."""
    rng = np.random.RandomState(5)
    xr = jnp.asarray(rng.randn(3, 70, 4).astype(np.float32) * 2)
    xc = jnp.asarray(rng.randn(3, 90, 4).astype(np.float32) * 2)
    h = jnp.asarray(rng.randn(3, 90, 20).astype(np.float32))
    offs = jnp.asarray([40, 0], jnp.int32)
    want, want_d = pf._adj_matmul_xla(xr, xc, h, offs, CR2)
    got, got_d = pf._adj_matmul_triton(xr, xc, h, offs, CR2, interpret=True)
    got_v, got_vd = jax.vmap(
        lambda a, b, c: pf._adj_matmul_triton(a, b, c, offs, CR2, interpret=True)
    )(xr, xc, h)
    for g, d in ((got, got_d), (got_v, got_vd)):
        assert g.shape == (3, 70, 20)
        np.testing.assert_allclose(np.asarray(g), np.asarray(want), atol=2e-5)
        np.testing.assert_array_equal(np.asarray(d), np.asarray(want_d))


def test_adjacency_routing_follows_backend(monkeypatch):
    """Each kernel runs exactly when JAX's default backend is a GPU."""
    from gym_flock_tpu.ops import sparse_flocking

    calls = []
    record = lambda tag: (lambda *a, **k: calls.append(tag))
    monkeypatch.setattr(pf, "_adj_matmul_triton", record("adj-k"))
    monkeypatch.setattr(pf, "_adj_matmul_xla", record("adj-x"))
    monkeypatch.setattr(sparse_flocking, "_table_sums_triton", record("table-k"))
    monkeypatch.setattr(sparse_flocking, "_sparse_sums_sorted", record("table-x"))
    xs = jnp.zeros((1, 128, 4))
    table = jnp.zeros((1, 1, 1), jnp.int32)
    for backend in ("gpu", "cpu", "other"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        pf._adj_tile(None, None, None, None, None)
        sparse_flocking._table_sums(xs, table, 0.9, 0.81, False)
    assert calls == ["adj-k", "table-k", "adj-x", "table-x", "adj-x", "table-x"]


@pytest.mark.gpu
def test_adjacency_kernel_compiled_on_gpu():
    """The compiled kernel == the XLA product on the card (full widths
    in chip_smoke.py)."""
    rng = np.random.RandomState(8)
    x = jnp.asarray(rng.randn(2, 1000, 4).astype(np.float32) * 8)
    h = jnp.asarray(rng.randn(2, 1000, 6).astype(np.float32))
    zero = jnp.zeros((2,), jnp.int32)
    got, got_d = jax.jit(pf._adj_matmul_triton)(x, x, h, zero, CR2)
    want, want_d = jax.jit(pf._adj_matmul_xla)(x, x, h, zero, CR2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(got_d), np.asarray(want_d))


# ------------------------------------------------- coverage greedy row-min


def _packed_min_oracle(cost, g, cur, blocked):
    rows = np.asarray(cost, np.float64)[g][cur]  # [R, T]
    vals = np.where(blocked[None, :], 1024.0, rows)
    loc = np.argmin(vals, axis=1)  # first index among ties
    return vals[np.arange(len(cur)), loc] * 8192.0 + loc


@pytest.mark.parametrize(
    "B,R,T,G", [(3, 5, 137, 2), (2, 33, 300, 1), (4, 100, 260, 1)]
)
def test_rowmin_kernel_matches_xla_exactly(B, R, T, G):
    """The packed greedy min equals the NumPy (value, first index) argmin
    EXACTLY, batched over envs: multi-graph banks, ties, all-blocked envs
    (unreachable decode) and T off any power of two."""
    from gym_flock_tpu.envs.coverage import _packed_greedy_min as packed_greedy_min

    rng = np.random.RandomState(7)
    mm = rng.randint(0, 20, size=(G, T, T)).astype(np.float32)
    mm[rng.rand(G, T, T) < 0.1] = 1024.0
    g = rng.randint(0, G, size=B)
    cur = rng.randint(0, T, size=(B, R))
    blocked = rng.rand(B, T) < 0.6
    blocked[0] = True  # one fully-blocked env

    got = jax.vmap(packed_greedy_min, in_axes=(None, 0, 0, 0))(
        jnp.asarray(mm, jnp.bfloat16), jnp.asarray(g), jnp.asarray(cur),
        jnp.asarray(blocked),
    )
    want = np.stack([_packed_min_oracle(mm, g[b], cur[b], blocked[b]) for b in range(B)])
    np.testing.assert_array_equal(np.asarray(got, np.float64), want)


def test_rowmin_controller_route_equivalence():
    """The controller's packed-min gather route (bf16 cost copy) gives the
    same expert actions as the plain argmin route on the f32 table,
    single-env and vmapped."""
    import gym_flock_tpu as gft

    env, params = gft.make("Coverage-v0", n_graphs=2)
    assert "graph_cost_bf16" in params.bank and "cost_pack_ok" in params.bank
    p_row = params
    bank_ref = {k: v for k, v in params.bank.items()
                if k not in ("graph_cost_bf16", "cost_pack_ok")}
    p_ref = params.replace(bank=bank_ref)

    key = jax.random.key(3)
    s, _ = env.reset_env(key, p_ref)
    for t in range(8):
        kt = jax.random.fold_in(key, t)
        u_ref = env.controller(s, p_ref, key=kt, greedy=True)
        u_row = env.controller(s, p_row, key=kt, greedy=True)
        np.testing.assert_array_equal(np.asarray(u_row), np.asarray(u_ref))
        s, _, _, _, _ = env.step_env(kt, s, u_ref, p_ref)

    keys = jax.random.split(jax.random.key(9), 4)
    sb, _ = jax.vmap(env.reset_env, in_axes=(0, None))(keys, p_ref)
    ub_ref = jax.vmap(lambda st, k: env.controller(st, p_ref, key=k, greedy=True))(sb, keys)
    ub_row = jax.vmap(lambda st, k: env.controller(st, p_row, key=k, greedy=True))(sb, keys)
    np.testing.assert_array_equal(np.asarray(ub_row), np.asarray(ub_ref))
