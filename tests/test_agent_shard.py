"""Agent-axis sharding vs the dense single-device kernels.

The sharded kernels (parallel/agent_shard.py) split the swarm's agent axis
over a mesh axis; these tests run them on the virtual 8-device CPU mesh and
check them against the dense [N, N] kernels of envs/flocking.py — same
inputs, per-agent outputs equal up to summation-order float error.
"""
import jax

# other suite files flip this global flag; set it unconditionally so these
# tests see the same RNG streams standalone as inside the full suite
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from gym_flock_tpu.envs.flocking import (
    FlockingParams,
    _integrate,
    _pairwise_channels,
    flocking_features,
    turner_controller,
    turner_potential_grad,
)
from gym_flock_tpu.parallel.agent_shard import (
    adjacency_matmul_sharded,
    agent_sharded_rollout,
    flocking_reset_sharded,
    flocking_step_sharded,
    flocking_sums_sharded,
    make_flock_mesh,
    turner_controller_sharded,
)

N = 64
PARAMS = FlockingParams(n_agents=N)


def _swarm(key, n=N):
    x = jax.random.normal(key, (n, 4), jnp.float32)
    # spread positions so the radius graph has structure (some pairs in
    # range, some out) at comm_radius=0.9
    return x.at[:, :2].mul(2.0)


def _dense_sums(x, params):
    """Expected channel sums from the dense kernels (module docstring layout)."""
    values, adj, _, r2 = flocking_features(x, params.comm_radius2)
    dx, dy, _, _, _ = _pairwise_channels(x)
    gx_mat = turner_potential_grad(dx, r2, params.comm_radius)
    gy_mat = turner_potential_grad(dy, r2, params.comm_radius)
    deg = jnp.sum(adj, axis=1)
    min_r2 = jnp.min(r2, axis=1)
    return jnp.concatenate(
        [
            values,
            jnp.sum(gx_mat, axis=1)[:, None],
            jnp.sum(gy_mat, axis=1)[:, None],
            deg[:, None],
            min_r2[:, None],
            jnp.sum(gx_mat * adj, axis=1)[:, None],
            jnp.sum(gy_mat * adj, axis=1)[:, None],
        ],
        axis=1,
    )


@pytest.fixture(scope="module")
def mesh8(devices8):
    return jax.sharding.Mesh(np.asarray(devices8[:8]), ("ap",))


@pytest.mark.parametrize("mode", ["ring", pytest.param("allgather", marks=pytest.mark.slow)])
def test_sums_match_dense(mesh8, mode):
    x = _swarm(jax.random.key(0))
    expected = _dense_sums(x, PARAMS)

    fn = jax.shard_map(
        lambda xl: flocking_sums_sharded(
            xl, PARAMS.comm_radius, PARAMS.comm_radius2, "ap", mode
        ),
        mesh=mesh8,
        in_specs=P("ap"),
        out_specs=P("ap"),
    )
    got = fn(x)
    np.testing.assert_allclose(got, expected, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize(
    # default tier keeps the decentralized controller (the expert's mode);
    # the centralized variant differs only in the consensus term and rides
    # the same sharded kernels — slow tier
    "centralized", [pytest.param(True, marks=pytest.mark.slow), False]
)
@pytest.mark.parametrize("mode", ["ring", pytest.param("allgather", marks=pytest.mark.slow)])
def test_controller_matches_dense(mesh8, mode, centralized):
    x = _swarm(jax.random.key(1))
    expected = turner_controller(x, PARAMS, centralized=centralized)

    fn = jax.shard_map(
        lambda xl: turner_controller_sharded(
            xl, PARAMS, "ap", mode, centralized=centralized
        ),
        mesh=mesh8,
        in_specs=P("ap"),
        out_specs=P("ap"),
    )
    got = fn(x)
    np.testing.assert_allclose(got, expected, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["ring", "allgather"])
@pytest.mark.parametrize("mean_pool", [True, False])
def test_adjacency_matmul_sharded(mesh8, mode, mean_pool):
    kx, kh = jax.random.split(jax.random.key(2))
    x = _swarm(kx)
    h = jax.random.normal(kh, (N, 16), jnp.float32)

    _, adj, adj_mean, _ = flocking_features(x, PARAMS.comm_radius2)
    expected = (adj_mean if mean_pool else adj) @ h

    fn = jax.shard_map(
        lambda xl, hl: adjacency_matmul_sharded(
            xl, hl, PARAMS.comm_radius2, "ap", mode, mean_pool=mean_pool
        ),
        mesh=mesh8,
        in_specs=(P("ap"), P("ap")),
        out_specs=P("ap"),
    )
    got = fn(x, h)
    np.testing.assert_allclose(got, expected, rtol=2e-5, atol=2e-5)


@pytest.mark.slow  # ring variant; the allgather schedule is test_fused_step_pallas_tile
def test_fused_step_matches_dense(mesh8):
    """One sharded expert+integrate+obs+reward step == the dense env step."""
    x = _swarm(jax.random.key(3))

    u = turner_controller(x, PARAMS, centralized=True)
    x2_expected = _integrate(x, u, PARAMS.dt)
    values_expected, _, _, _ = flocking_features(x2_expected, PARAMS.comm_radius2)
    reward_expected = -1.0 * jnp.sum(jnp.var(x2_expected[:, 2:4], axis=0))

    fn = jax.shard_map(
        lambda xl: flocking_step_sharded(xl, PARAMS, "ap", "ring"),
        mesh=mesh8,
        in_specs=P("ap"),
        out_specs=(P("ap"), P("ap"), P()),
        check_vma=False,  # reward is psum'd -> replicated, but computed per-shard
    )
    x2, values, reward = fn(x)
    np.testing.assert_allclose(x2, x2_expected, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(values, values_expected, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(reward, reward_expected, rtol=2e-5, atol=2e-5)


def test_reset_sharded_accepts_and_is_shard_count_invariant(devices8):
    """Reset satisfies the acceptance predicate and the drawn swarm is the
    same function of the key at any agent-shard count.

    Default params have a ~0.7% acceptance rate at n=64 (the reference's
    rejection test is inherently tight, SURVEY.md §5.9b, and our loop is
    BOUNDED by design) — loosen min-dist so the acceptance rate is ~50% and
    256 tries make a spurious exhaustion essentially impossible."""
    params = FlockingParams(n_agents=64, min_dist_thresh=0.05, max_reset_tries=256)
    swarms = {}
    for p in (2, 4):
        mesh = jax.sharding.Mesh(np.asarray(devices8[:p]), ("ap",))
        fn = jax.shard_map(
            lambda k: flocking_reset_sharded(k[0], params, "ap", "ring"),
            mesh=mesh,
            in_specs=P(),
            out_specs=P("ap"),
            check_vma=False,
        )
        swarms[p] = np.asarray(fn(jnp.stack([jax.random.key(7)])))
    np.testing.assert_array_equal(swarms[2], swarms[4])

    x = jnp.asarray(swarms[2])
    _, _, _, _, r2 = _pairwise_channels(x)
    assert float(jnp.min(jnp.sqrt(r2))) > params.min_dist_thresh
    assert int(jnp.min(jnp.sum(r2 < params.comm_radius2, axis=1))) >= 2


@pytest.mark.parametrize("mode", ["ring", pytest.param("allgather", marks=pytest.mark.slow)])
def test_agent_sharded_rollout_2d_mesh(devices8, mode):
    """Full 2-D (dp x ap) fleet rollout runs and returns finite stats.

    max_reset_tries is capped low: at n=32 the default acceptance rate is
    ~0 (SURVEY.md §5.9b), and 64 futile ring passes inside the vmapped
    while_loop are slow enough on the 8-thread virtual CPU mesh to trip
    XLA's collective-rendezvous stuck detector (a CHECK failure, not a
    hang).  The bounded-tries semantics themselves are covered by the reset
    test above."""
    mesh = make_flock_mesh(2, 4, devices8)
    params = FlockingParams(n_agents=32, max_reset_tries=4)
    xs, mean_r = jax.jit(
        lambda k: agent_sharded_rollout(
            params, k, n_envs=4, n_steps=3, mesh=mesh, mode=mode
        )
    )(jax.random.key(11))
    assert xs.shape == (4, 32, 4)
    assert bool(jnp.all(jnp.isfinite(xs)))
    assert bool(jnp.isfinite(mean_r))


@pytest.mark.parametrize("mode", ["ring", pytest.param("allgather", marks=pytest.mark.slow)])
def test_sums_pallas_tile_matches_dense(mesh8, mode):
    """The core-channel tile (``channels="core"``: min-r2 and the masked
    gradient sums skipped) under shard_map equals the dense kernels on
    channels 0..8 and leaves 9..11 zero."""
    x = _swarm(jax.random.key(4))
    expected = _dense_sums(x, PARAMS)

    fn = jax.shard_map(
        lambda xl: flocking_sums_sharded(
            xl, PARAMS.comm_radius, PARAMS.comm_radius2, "ap", mode,
            channels="core",
        ),
        mesh=mesh8,
        in_specs=P("ap"),
        out_specs=P("ap"),
    )
    got = np.asarray(fn(x))
    err = np.abs(got[:, :9] - np.asarray(expected[:, :9])) / (
        1.0 + np.abs(np.asarray(expected[:, :9]))
    )
    assert err.max() < 1e-4
    assert not np.any(got[:, 9:])


def test_fused_step_pallas_tile(mesh8):
    """The fused sharded step on the allgather schedule == the dense step."""
    x = _swarm(jax.random.key(5))
    u = turner_controller(x, PARAMS, centralized=True)
    x2_expected = _integrate(x, u, PARAMS.dt)
    values_expected, _, _, _ = flocking_features(x2_expected, PARAMS.comm_radius2)

    fn = jax.shard_map(
        lambda xl: flocking_step_sharded(xl, PARAMS, "ap", "allgather"),
        mesh=mesh8,
        in_specs=P("ap"),
        out_specs=(P("ap"), P("ap"), P()),
        check_vma=False,  # reward is psum'd -> replicated, but computed per-shard
    )
    x2, values, reward = fn(x)
    np.testing.assert_allclose(x2, x2_expected, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(values, values_expected, rtol=2e-4, atol=2e-4)
    assert bool(jnp.isfinite(reward))


@pytest.mark.parametrize("mean_pool", [True, False])
def test_adjacency_matmul_sharded_pallas_tile(mesh8, mean_pool, triton_adj_tile):
    """Each ring tile run by the Triton kernel (interpret mode, global-id
    offsets per step) == the dense product."""
    kx, kh = jax.random.split(jax.random.key(6))
    x = _swarm(kx).astype(jnp.float32)
    h = jax.random.normal(kh, (N, 16), jnp.float32)

    _, adj, adj_mean, _ = flocking_features(x, PARAMS.comm_radius2)
    expected = (adj_mean if mean_pool else adj) @ h

    fn = jax.shard_map(
        lambda xl, hl: adjacency_matmul_sharded(
            xl, hl, PARAMS.comm_radius2, "ap", "ring", mean_pool=mean_pool
        ),
        mesh=mesh8,
        in_specs=(P("ap"), P("ap")),
        out_specs=P("ap"),
        # the Pallas interpreter's internal grid-loop indices are invariant
        # while the data varies over "ap", which the vma checker rejects
        check_vma=False,
    )
    got = fn(x, h)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(expected), rtol=2e-4, atol=2e-4
    )


@pytest.mark.slow  # both tiles; the sharded aggregation fwd+bwd is covered by test_agent_sharded_train_step_matches_dense[True]
@pytest.mark.parametrize("kernel_tile", [False, True])
def test_khop_aggregate_sharded_matches_and_differentiates(mesh8, request, kernel_tile):
    """Sharded K-hop aggregation == dense ops.khop_aggregate, AND its
    gradient wrt features matches dense autodiff through the
    swapped-operand custom VJP of adjacency_matmul_block — with each tile
    the XLA product or the Triton kernel (interpret mode)."""
    from gym_flock_tpu.ops.pallas_flocking import khop_aggregate
    from gym_flock_tpu.parallel.agent_shard import khop_aggregate_sharded

    kx, kh, kc = jax.random.split(jax.random.key(8), 3)
    x = _swarm(kx).astype(jnp.float32)
    feats = jax.random.normal(kh, (N, 6), jnp.float32)
    co = jax.random.normal(kc, (N, 18), jnp.float32)  # k_hops * F

    want = khop_aggregate(x, feats, PARAMS.comm_radius2, k_hops=3)
    want_g = jax.grad(
        lambda f: jnp.sum(khop_aggregate(x, f, PARAMS.comm_radius2, k_hops=3) * co)
    )(feats)
    if kernel_tile:
        request.getfixturevalue("triton_adj_tile")

    fn = jax.shard_map(
        lambda xl, fl: khop_aggregate_sharded(
            xl, fl, PARAMS.comm_radius2, 3, "ap", "ring"
        ),
        mesh=mesh8,
        in_specs=(P("ap"), P("ap")),
        out_specs=P("ap"),
        check_vma=not kernel_tile,  # interpreter limitation, see above
    )
    got = fn(x, feats)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    got_g = jax.grad(lambda f: jnp.sum(fn(x, f) * co))(feats)
    np.testing.assert_allclose(got_g, want_g, rtol=2e-5, atol=2e-5)


@pytest.mark.slow  # full-rollout variant; fused step + controller equivalences cover the kernels fast
def test_agent_sharded_rollout_fused_matches_stepwise(devices8):
    """The fused rollout (carried ring-pass sums) == the per-step
    flocking_step_sharded loop from the same reset."""
    from jax.sharding import PartitionSpec as P

    from gym_flock_tpu.envs.flocking import FlockingParams
    from gym_flock_tpu.parallel import agent_sharded_rollout, make_flock_mesh
    from gym_flock_tpu.parallel.agent_shard import (
        flocking_reset_sharded,
        flocking_step_sharded,
    )

    params = FlockingParams(n_agents=16, max_reset_tries=4)
    mesh = make_flock_mesh(2, 2)
    dp, ap = mesh.axis_names

    xs_f, mr_f = agent_sharded_rollout(
        params, jax.random.key(5), n_envs=4, n_steps=3, mesh=mesh, mode="ring"
    )

    def local_fn(keys_local):
        def one_env(key):
            x0 = flocking_reset_sharded(key, params, ap, "ring", False, False)

            def body(x, _):
                x2, _, r = flocking_step_sharded(x, params, ap, "ring", False, False)
                return x2, r

            x, rs = jax.lax.scan(body, x0, None, length=3)
            return x, jnp.mean(rs)

        xs, mr = jax.vmap(one_env)(keys_local)
        return xs, jax.lax.pmean(jnp.mean(mr), dp)

    keys = jax.random.split(jax.random.key(5), 4)
    xs_s, mr_s = jax.shard_map(
        local_fn, mesh=mesh, in_specs=P(dp), out_specs=(P(dp, ap), P()),
        check_vma=False,
    )(keys)
    np.testing.assert_allclose(
        np.asarray(xs_f), np.asarray(xs_s), rtol=2e-4, atol=1e-5
    )
    np.testing.assert_allclose(float(mr_f), float(mr_s), rtol=1e-4)
