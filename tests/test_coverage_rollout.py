"""Coverage under the rollout engine: autoreset resamples graphs mid-scan."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

import gym_flock_tpu as gft
from gym_flock_tpu.parallel import batch_rollout, rollout


def test_coverage_batch_rollout_random_policy():
    env, params = gft.make("Coverage-v0", n_graphs=2)
    _, traj = jax.jit(
        lambda k: batch_rollout(env, params, k, n_envs=4, n_steps=10,
                                policy="random", keep_obs=False)
    )(jax.random.key(0))
    assert traj.reward.shape == (4, 10)
    assert np.isfinite(np.asarray(traj.reward)).all()


def test_coverage_autoreset_resamples_graph():
    # short episodes force autoreset inside the scan; with a 4-graph bank the
    # graph index should change across episode boundaries
    env, params = gft.make("Coverage-v0", n_graphs=4, episode_length=3, max_steps=3)

    def greedy(key, state, obs, p):
        return env.controller(state, p, key=key, greedy=True)

    state, traj = rollout(env, params, jax.random.key(1), n_steps=24, policy=greedy)
    d = np.asarray(traj.done)
    assert d.sum() >= 5  # several episode boundaries
    assert np.isfinite(np.asarray(traj.reward)).all()


def test_coverage_expert_policy_through_rollout():
    env, params = gft.make("Coverage-v0", n_graphs=1)

    def greedy(key, state, obs, p):
        return env.controller(state, p, key=key, greedy=True)

    _, traj = rollout(env, params, jax.random.key(2), n_steps=60, policy=greedy,
                      auto_reset=False)
    total = float(np.sum(np.asarray(traj.reward)))
    assert total > 20  # greedy expert makes steady coverage progress


def test_full_variants_use_whole_map():
    env, params = gft.make("CoverageFull-v0")
    assert int(params.bank["n_targets"][0]) > 500  # full map, not a subwindow
    state, obs = env.reset_env(jax.random.key(0), params)
    u = env.controller(state, params, key=jax.random.key(1), greedy=True)
    state, obs, r, d, _ = env.step_env(jax.random.key(2), state, u, params)
    assert np.isfinite(float(r))


def test_explore_full_100_robots():
    env, params = gft.make("ExploreFullEnv-v0")
    assert params.n_robots == 100 and params.hide_nodes
    state, obs = env.reset_env(jax.random.key(0), params)
    total = 0.0
    key = jax.random.key(1)
    for _ in range(5):
        key, k1, k2 = jax.random.split(key, 3)
        u = env.controller(state, params, key=k1, greedy=True)
        state, obs, r, d, _ = env.step_env(k2, state, u, params)
        total += float(r)
    assert total > 0


def test_bank_save_load_roundtrip(tmp_path):
    from gym_flock_tpu.envs.coverage_graph import load_graph_bank, save_graph_bank
    from gym_flock_tpu.envs.coverage import default_coverage_bank, CoverageParams, CoverageEnv

    bank = default_coverage_bank(n_graphs=1, seed=3)
    path = str(tmp_path / "bank.npz")
    save_graph_bank(path, bank)
    bank2 = load_graph_bank(path)
    for k in bank:
        np.testing.assert_array_equal(np.asarray(bank[k]), np.asarray(bank2[k]))
    env = CoverageEnv()
    params = CoverageParams(bank=bank2)
    state, obs = env.reset_env(jax.random.key(0), params)
    assert "nodes" in obs


def test_bank_schema_version_checked(tmp_path):
    """A .npz with a stale or missing __bank_schema__ must refuse to load
    (the cache path then rebuilds): format bumps can't silently serve
    stale banks (VERDICT r3 #6)."""
    from gym_flock_tpu.envs.coverage import default_coverage_bank
    from gym_flock_tpu.envs.coverage_graph import (
        BANK_SCHEMA, load_graph_bank, save_graph_bank,
    )

    bank = default_coverage_bank(n_graphs=1, seed=3)
    path = str(tmp_path / "bank.npz")
    save_graph_bank(path, bank)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    assert int(arrays["__bank_schema__"]) == BANK_SCHEMA

    arrays["__bank_schema__"] = np.asarray(BANK_SCHEMA + 1)
    np.savez_compressed(str(tmp_path / "stale.npz"), **arrays)
    with pytest.raises(ValueError, match="schema"):
        load_graph_bank(str(tmp_path / "stale.npz"))

    del arrays["__bank_schema__"]
    np.savez_compressed(str(tmp_path / "legacy.npz"), **arrays)
    with pytest.raises(ValueError, match="__bank_schema__"):
        load_graph_bank(str(tmp_path / "legacy.npz"))


def _sequential_reference(cur, chosen, collision_checks=True):
    """The reference's exact two-pass procedure (coverage.py:186-201), NumPy."""
    R = len(cur)
    nxt = [-1] * R
    for i in range(R):
        if chosen[i] == cur[i]:
            nxt[i] = chosen[i]
    for i in range(R):
        if nxt[i] == -1:
            if (not collision_checks) or (chosen[i] not in nxt):
                nxt[i] = chosen[i]
            else:
                nxt[i] = cur[i]
    return np.asarray(nxt)


def test_parallel_conflict_resolution_fuzz():
    """The fixed-point resolver must equal the sequential procedure on
    thousands of adversarial cases (tiny node universes force collisions,
    duplicate current positions are legal per the reference's own quirk)."""
    import jax.numpy as jnp

    from gym_flock_tpu.envs.coverage import _resolve_conflicts

    rng = np.random.RandomState(0)
    checked = 0
    for R, n_nodes, trials in [(2, 2, 200), (3, 2, 300), (6, 3, 500),
                               (6, 8, 300), (12, 4, 300), (100, 30, 50)]:
        resolve = jax.jit(
            lambda c, ch: _resolve_conflicts(c, ch, collision_checks=True)
        )
        for _ in range(trials):
            cur = rng.randint(0, n_nodes, size=R)
            chosen = rng.randint(0, n_nodes, size=R)
            want = _sequential_reference(cur, chosen)
            got = np.asarray(resolve(jnp.asarray(cur), jnp.asarray(chosen)))
            np.testing.assert_array_equal(
                got, want, err_msg=f"R={R} cur={cur} chosen={chosen}"
            )
            checked += 1
    assert checked == 1650


def test_expert_policy_string_passes_key():
    """policy='expert' must thread the per-step key into coverage's
    controller (the random fallback for unreachable targets)."""
    env, params = gft.make("Coverage-v0", n_graphs=1)
    _, traj = rollout(env, params, jax.random.key(4), n_steps=30, policy="expert")
    assert np.isfinite(np.asarray(traj.reward)).all()
    # greedy expert makes progress (key pass-through didn't break routing)
    assert float(np.sum(np.asarray(traj.reward))) > 5


def test_nearby_starts_region_is_local_despite_horizon():
    """Start regions use uncapped BFS hops: with a horizon-capped cost
    matrix the region must still be a local cluster, not the whole map."""
    env, params = gft.make("Coverage-v0", n_graphs=1)  # horizon=10
    g = 0
    hops = np.asarray(params.bank["graph_hops"][g])
    n_t = int(params.bank["n_targets"][g])
    state, _ = env.reset_env(jax.random.key(7), params)
    locs = np.asarray(state.robot_loc)
    # all six robots within a small hop radius of each other
    pair_hops = hops[np.ix_(locs, locs)]
    assert np.isfinite(pair_hops).all()
    assert pair_hops.max() <= 20, pair_hops.max()


def test_revisit_nodes_flag_reverts_targets():
    """REVISIT_NODES: visited landmarks occasionally revert to unvisited
    (reference coverage.py:246-247, w.p. 0.005 per step)."""
    env, params = gft.make("Coverage-v0", n_graphs=1, revisit_nodes=True)
    mask = jnp.asarray(np.asarray(params.bank["target_mask"][0]))

    @jax.jit
    def rollout(key):
        state, _ = env.reset_env(jax.random.key(0), params)

        def body(state, key_t):
            k1, k2 = jax.random.split(key_t)
            before = jnp.sum(state.visited * mask)
            u = env.controller(state, params, key=k1, greedy=True)
            state, _, r, d, _ = env.step_env(k2, state, u, params)
            after = jnp.sum(state.visited * mask)
            # a revert shows as visited-count decreasing net of new visits
            return state, (after - before < r)
        _, reverts = jax.lax.scan(body, state, jax.random.split(key, 120))
        return jnp.sum(reverts)

    assert int(rollout(jax.random.key(1))) > 0, \
        "no visited target ever reverted in 120 steps"


@pytest.mark.slow  # bf16 packed route covered fast by test_multi_graph_mm_expert_matches_gather; hide-nodes masks by test_hide_mm_discovery_masks
@pytest.mark.parametrize("hide_nodes", [False, True])
def test_mxu_greedy_expert_matches_gather_path(hide_nodes):
    """The greedy expert's packed min over bf16 cost rows (single-graph
    bank, large R) is action-for-action identical to the variadic argmin
    over the f32 table over a rollout.  hide_nodes exercises the
    discovery-masked blocked set."""
    env, params = gft.make(
        "Coverage-v0", n_graphs=1, n_robots=20,
        hide_nodes=hide_nodes, n_node_feat=4 if hide_nodes else 3,
    )
    assert "graph_cost_bf16" in params.bank, "bank should carry the bf16 copy"
    assert params.bank["graph_cost_bf16"].shape[0] == 1

    # strip the bf16 copy and the pack marker: the plain argmin path
    params_gather = params.replace(
        bank={k: v for k, v in params.bank.items()
              if k not in ("graph_cost_bf16", "cost_pack_ok")}
    )

    state_a, _ = env.reset_env(jax.random.key(3), params)
    state_b, _ = env.reset_env(jax.random.key(3), params_gather)
    key = jax.random.key(4)
    for _ in range(15):
        key, k1, k2 = jax.random.split(key, 3)
        u_a = env.controller(state_a, params, key=k1, greedy=True)
        u_b = env.controller(state_b, params_gather, key=k1, greedy=True)
        np.testing.assert_array_equal(np.asarray(u_a), np.asarray(u_b))
        state_a, _, r_a, _, _ = env.step_env(k2, state_a, u_a, params)
        state_b, _, r_b, _, _ = env.step_env(k2, state_b, u_b, params_gather)
        np.testing.assert_array_equal(
            np.asarray(state_a.robot_loc), np.asarray(state_b.robot_loc)
        )
        assert float(r_a) == float(r_b)


def test_multi_graph_mm_expert_matches_gather():
    """On a multi-graph bank the packed min over bf16 cost rows (indexed
    by each env's graph) produces IDENTICAL greedy actions to the plain
    argmin over the f32 table, for every graph in the bank."""
    env, params = gft.make("Coverage-v0", n_graphs=4, n_robots=16)
    assert "graph_cost_bf16" in params.bank and "cost_pack_ok" in params.bank
    bank_nomm = {k: v for k, v in params.bank.items()
                 if k not in ("graph_cost_bf16", "cost_pack_ok")}
    params_nomm = params.replace(bank=bank_nomm)

    for g in range(4):
        key = jax.random.key(100 + g)
        state, _ = env.reset_env(key, params)
        state = state.replace(graph=jnp.int32(g))
        # re-derive a valid robot placement for this graph
        n_t = int(params.bank["n_targets"][g])
        state = state.replace(
            robot_loc=(jnp.arange(16, dtype=jnp.int32) * 3) % n_t
        )
        for t in range(3):
            kt = jax.random.key(t)
            u_mm = env.controller(state, params, key=kt, greedy=True)
            u_gather = env.controller(state, params_nomm, key=kt, greedy=True)
            np.testing.assert_array_equal(np.asarray(u_mm), np.asarray(u_gather))
            state, _, _, _, _ = env.step_env(kt, state, u_mm, params)


def test_small_r_mm_expert_matches_gather():
    """At the default R=6 the packed min gives the same actions whether it
    gathers rows from the bf16 cost copy or from the f32 table (a bank
    without the copy): the copy is exact, unreachable included."""
    env, params = gft.make("Coverage-v0", n_graphs=4)
    assert params.bank["graph_cost_bf16"].dtype == jnp.bfloat16
    params_gather = params.replace(
        bank={k: v for k, v in params.bank.items() if k != "graph_cost_bf16"}
    )
    assert "cost_pack_ok" in params_gather.bank

    key = jax.random.key(11)
    state, _ = env.reset_env(key, params)
    for t in range(10):
        kt = jax.random.key(200 + t)
        u_mm = env.controller(state, params, key=kt, greedy=True)
        u_gather = env.controller(state, params_gather, key=kt, greedy=True)
        np.testing.assert_array_equal(np.asarray(u_mm), np.asarray(u_gather))
        state, _, _, _, _ = env.step_env(kt, state, u_mm, params)


def test_cost_pack_marker_bounds_packing_range():
    """The packed min encodes cost*8192+idx, so indices >= 8192 would
    alias onto cost+1: _cost_pack_marker keeps the packed route for
    T=8192 (the last exact width) and drops it beyond, sending the
    expert to the variadic argmin."""
    from types import SimpleNamespace

    from gym_flock_tpu.envs.coverage_graph import _cost_pack_marker

    edge = SimpleNamespace(graph_cost=np.zeros((2, 8192), np.float32))
    assert "cost_pack_ok" in _cost_pack_marker([edge])
    big = SimpleNamespace(graph_cost=np.zeros((2, 8193), np.float32))
    assert _cost_pack_marker([big]) == {}


def test_explicit_bank_plus_real_map_raises():
    """real_map alongside an explicit bank= cannot be honored — reject it
    explicitly instead of silently ignoring the map (ADVICE r3, low)."""
    env, params = gft.make("CoverageARL-v0", n_graphs=2, real_map=False)
    with pytest.raises(ValueError, match="explicit bank"):
        gft.make("CoverageARL-v0", bank=params.bank, real_map=True)
    # and real_map=None/False with a bank stays fine
    env2, params2 = gft.make("CoverageARL-v0", bank=params.bank)
    # the bank is REUSED, not rebuilt: every array leaf is the same object
    # (params get their own shallow dict so shared-cache eviction can't
    # touch live envs — identity holds per leaf, not per dict)
    for k, v in params.bank.items():
        assert params2.bank[k] is v, k


def test_cost_pack_marker_validates_full_array():
    """_cost_pack_marker guards the FULL cost array (unreachable clamps
    included) against the f32 pack-exact bound cost <= 2047 (ADVICE r3,
    low: the old finite-only max check was dead code)."""
    from types import SimpleNamespace

    from gym_flock_tpu.envs.coverage_graph import MAX_COST, _cost_pack_marker

    spec = SimpleNamespace(graph_cost=np.array([[0.0, 3.0], [MAX_COST, 1.0]]))
    assert "cost_pack_ok" in _cost_pack_marker([spec])
    # a cost above the pack-exact bound (even below any hypothetical larger
    # clamp) must drop the marker
    spec_big = SimpleNamespace(graph_cost=np.array([[0.0, 2048.0], [1.0, 1.0]]))
    assert _cost_pack_marker([spec_big]) == {}
    # non-integral costs drop it too
    spec_frac = SimpleNamespace(graph_cost=np.array([[0.0, 1.5], [1.0, 1.0]]))
    assert _cost_pack_marker([spec_frac]) == {}


@pytest.mark.parametrize("env_id,mk", [
    # G=2 segment-flattened operands: slow tier (G=1 covers the mask path)
    pytest.param("ExploreEnv-v0", dict(n_graphs=2), marks=pytest.mark.slow),
    ("ExploreFullEnv-v0", dict()),          # G=1 (the flagship env)
])
def test_hide_mm_discovery_masks_match_gather_path(env_id, mk):
    """The one-hot discovery-mask path (one-hot matmuls over the motion block,
    tail handled by the radius argument — coverage._hide_mm_active) is
    BITWISE equal to the gather+scatter path: every obs leaf, reward, and
    the discovered mask, over a rollout long enough to grow discovery."""
    from gym_flock_tpu.envs.coverage import _hide_mm_active

    env, params = gft.make(env_id, **mk)
    assert _hide_mm_active(params), "factory should auto-engage the fast path"
    assert "hide_send_onehot" in params.bank
    p_slow = params.replace(hide_mm=False)
    assert not _hide_mm_active(p_slow)

    key = jax.random.key(3)
    state_f, obs_f = env.reset_env(key, params)
    state_s, obs_s = env.reset_env(key, p_slow)
    for k in obs_f:
        a, b = np.asarray(obs_f[k]), np.asarray(obs_s[k])
        if not np.array_equal(a, b):  # pragma: no cover - debug dump
            d = np.argwhere(a != b)
            print("DBG leaf", k, "mismatch at", d[:5].tolist())
            print("DBG x64", jax.config.jax_enable_x64)
            print("DBG graph", int(state_f.graph), int(state_s.graph))
            print("DBG robot_loc f", np.asarray(state_f.robot_loc),
                  "s", np.asarray(state_s.robot_loc))
            print("DBG disc sum f", float(np.asarray(state_f.discovered).sum()),
                  "s", float(np.asarray(state_s.discovered).sum()))
            row = int(d[0][0])
            print("DBG row", row, "fast", a[row].tolist(), "slow", b[row].tolist())
        np.testing.assert_array_equal(a, b)
    for t in range(8):
        kt = jax.random.fold_in(key, t)
        k1, k2 = jax.random.split(kt)
        u_f = env.controller(state_f, params, key=k1, greedy=True)
        u_s = env.controller(state_s, p_slow, key=k1, greedy=True)
        np.testing.assert_array_equal(np.asarray(u_f), np.asarray(u_s))
        state_f, obs_f, r_f, d_f, _ = env.step_env(k2, state_f, u_f, params)
        state_s, obs_s, r_s, d_s, _ = env.step_env(k2, state_s, u_s, p_slow)
        for k in obs_f:
            np.testing.assert_array_equal(
                np.asarray(obs_f[k]), np.asarray(obs_s[k]), err_msg=f"t={t} {k}"
            )
        assert float(r_f) == float(r_s)
        np.testing.assert_array_equal(
            np.asarray(state_f.discovered), np.asarray(state_s.discovered)
        )


def test_hide_mm_gate_is_static_and_radius_guarded():
    """_hide_mm_active reads only static fields (params may be traced) and
    the tail-radius condition cannot be overridden by hide_mm=True."""
    from gym_flock_tpu.envs.coverage import _hide_mm_active

    env, params = gft.make("ExploreFullEnv-v0")
    # force-True with a discover_radius below the bank's longest edge must
    # fall back (correctness gate, not a heuristic)
    bad = params.replace(
        hide_mm=True, discover_radius=params.max_neighbor_dist / 2
    )
    assert not _hide_mm_active(bad)

    # params as a traced jit argument: the gate must not read dynamic leaves
    state, _ = env.reset_env(jax.random.key(0), params)

    @jax.jit
    def step(s, p):
        u = env.controller(s, p, key=jax.random.key(1), greedy=True)
        return env.step_env(jax.random.key(2), s, u, p)

    s2, obs, r, d, _ = step(state, params)
    assert obs["nodes"].shape[0] == params.max_targets + params.n_robots


def test_hide_mm_self_pad_frontier_quirk():
    """A robot does NOT discover the node it stands on (the reference's
    d > 0 quirk in _nodes_within_radius, utils.py:27-39), so a SELF-padded
    action edge can carry an undiscovered sender and flag the robot's own
    frontier row.  Regression: the fast path originally assumed all tail
    senders discovered and missed this (caught by an x64 reset placement).
    Construct the case deterministically and require BOTH paths to flag
    the robot."""
    from gym_flock_tpu.envs.coverage import _hide_mm_active

    env, params = gft.make("ExploreEnv-v0", n_graphs=2)
    assert _hide_mm_active(params)
    R = params.n_robots
    nt = np.asarray(params.bank["neighbor_table"])[0]
    n_t = int(np.asarray(params.bank["n_targets"])[0])
    pos = np.asarray(params.bank["target_pos"])[0]
    # a real node with a self-pad slot (degree < n_actions)
    self_pad = (nt == np.arange(nt.shape[0])[:, None]).any(axis=1)
    cands = np.nonzero(self_pad[:n_t])[0]
    assert len(cands) > 0
    s = int(cands[0])
    # other robots farther than discover_radius from s (and from its nbrs)
    far = np.nonzero(
        (np.linalg.norm(pos[:n_t] - pos[s], axis=1)
         > params.discover_radius + 2 * params.res)
    )[0]
    robot_loc = np.array([s] + list(far[: R - 1]), dtype=np.int32)

    state, _ = env.reset_env(jax.random.key(0), params)
    state = state.replace(
        robot_loc=jnp.asarray(robot_loc),
        discovered=jnp.zeros_like(state.discovered),
    )
    obs_f, r_f, d_f, _ = env._obs_reward(state, params)
    obs_s, r_s, d_s, _ = env._obs_reward(state, params.replace(hide_mm=False))
    for k in obs_f:
        np.testing.assert_array_equal(
            np.asarray(obs_f[k]), np.asarray(obs_s[k]), err_msg=k
        )
    # the edge case actually fired: robot 0's frontier flag is set
    assert float(np.asarray(obs_s["nodes"])[0, 3]) == 1.0


def test_packed_min_greedy_matches_argmin_path():
    """The gather-path packed single-value min (cost*8192+idx, engaged via
    the bank's ``cost_pack_ok`` marker — coverage_graph._cost_pack_marker)
    selects EXACTLY the same greedy actions as the variadic-argmin path,
    including first-match tie-breaks and the unreachable->random fallback,
    across rollouts that grow visited/discovered masks."""
    env, params = gft.make("ExploreFullEnv-v0")
    assert "cost_pack_ok" in params.bank

    # the argmin variant gets a bank WITHOUT the marker (presence is the gate)
    bank_no_marker = {k: v for k, v in params.bank.items() if k != "cost_pack_ok"}
    p_argmin = params.replace(bank=bank_no_marker)

    state, _ = env.reset_env(jax.random.key(3), params)
    for t in range(12):
        kt = jax.random.key(500 + t)
        u_packed = env.controller(state, params, key=kt, greedy=True)
        u_argmin = env.controller(state, p_argmin, key=kt, greedy=True)
        np.testing.assert_array_equal(np.asarray(u_packed), np.asarray(u_argmin))
        state, _, _, _, _ = env.step_env(kt, state, u_packed, params)


def test_disc_reach_table_matches_pairwise_discovery():
    """The static discovery-reach table (coverage_graph.disc_reach_operand,
    one one-hot matmul) is equivalent to the [R, n_all] pairwise
    nodes_within_radius pass: identical discovered masks, obs leaves,
    rewards and greedy actions over a 12-step rollout; a post-factory
    discover_radius override misses the radius-embedded key and falls
    back to the pairwise path."""
    env, params = gft.make("ExploreEnv-v0", n_graphs=2)
    reach_keys = [k for k in params.bank if k.startswith("disc_reach_r")]
    assert reach_keys, "factory should attach the reach table"

    bank_no = {k: v for k, v in params.bank.items() if not k.startswith("disc_reach")}
    p_fall = params.replace(bank=bank_no)
    key = jax.random.key(0)
    s1, o1 = env.reset_env(key, params)
    s2, o2 = env.reset_env(key, p_fall)
    for t in range(12):
        kt = jax.random.key(100 + t)
        u1 = env.controller(s1, params, key=kt, greedy=True)
        u2 = env.controller(s2, p_fall, key=kt, greedy=True)
        np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))
        s1, o1, r1, d1, _ = env.step_env(kt, s1, u1, params)
        s2, o2, r2, d2, _ = env.step_env(kt, s2, u2, p_fall)
        np.testing.assert_array_equal(
            np.asarray(s1.discovered), np.asarray(s2.discovered)
        )
        for k in o1:
            np.testing.assert_array_equal(
                np.asarray(o1[k]), np.asarray(o2[k]), err_msg=k
            )
        assert float(r1) == float(r2)

    # radius override -> static key miss -> pairwise fallback still works
    p_over = params.replace(discover_radius=float(params.discover_radius) * 2)
    from gym_flock_tpu.envs.coverage_graph import reach_key

    assert reach_key(p_over.discover_radius) not in p_over.bank
    s3, o3 = env.reset_env(key, p_over)
    u3 = env.controller(s3, p_over, key=key, greedy=True)
    s3, o3, r3, d3, _ = env.step_env(key, s3, u3, p_over)
    assert np.isfinite(float(r3))


def test_reach_key_full_precision():
    """ADVICE r4 #1: radii differing past 6 significant digits must not
    collide (the old %g key mapped 5.0 and 5.0000001 to the same table)."""
    from gym_flock_tpu.envs.coverage_graph import reach_key

    assert reach_key(5.0) != reach_key(5.0000001)
    assert reach_key(5.0) == reach_key(5)
    # round-trips: the key embeds the exact float
    assert float.fromhex(reach_key(2.5)[len("disc_reach_r"):]) == 2.5


def test_disc_reach_tie_case_is_f64_canonical():
    """ADVICE r4 #2: the reach table decides distance==radius boundary ties
    at f64 over the bank-stored f32 positions (like the reference's NumPy,
    utils.py:27-39), while the f32 runtime fallback may round the other
    way.  Pin the canonical behavior: find an f32 coordinate pair whose
    f32-arithmetic decision differs from f64, and assert the table sides
    with f64."""
    from gym_flock_tpu.envs.coverage_graph import disc_reach_operand, reach_key

    rad = 1.0
    found = None
    # scan f32 lattice offsets near r/sqrt(2): dx=dy=c, dist=c*sqrt(2)
    base = np.float32(rad / np.sqrt(2.0))
    for i in range(-3000, 3000):
        c = np.float32(base + np.float32(i) * np.float32(6e-8))
        # f32 sequence of ops.pairwise.nodes_within_radius: diff, square,
        # sum, sqrt, compare — all at f32
        d32 = np.sqrt(np.float32(c) * np.float32(c) + np.float32(c) * np.float32(c))
        in32 = bool(d32 <= np.float32(rad))
        cd = np.float64(c)
        in64 = bool(np.sqrt(cd * cd + cd * cd) <= rad)
        if in32 != in64:
            found = (c, in32, in64)
            break
    assert found is not None, "no f32/f64 boundary disagreement found in scan"
    c, in32, in64 = found
    pos = np.zeros((1, 2, 2), dtype=np.float32)
    pos[0, 1] = (c, c)
    table = disc_reach_operand({"target_pos": pos}, rad)[reach_key(rad)]
    got = bool(np.asarray(table, dtype=np.float32)[0, 1] > 0)
    assert got == in64, (
        f"table must decide ties at f64 (f32 says {in32}, f64 says {in64})"
    )


def test_disc_reach_table_eviction_cap():
    """ADVICE r4 #3: sweeping discover_radius across many make() calls must
    not accumulate unbounded device-resident reach tables in the shared
    memoized bank — at most 4 disc_reach_* keys are kept (oldest evicted),
    and the most recent radius always has its table attached."""
    from gym_flock_tpu.envs.coverage_graph import reach_key

    radii = [1.3, 1.4, 1.5, 1.6, 1.7, 1.8]
    first_params = None
    for r in radii:
        env, params = gft.make("ExploreEnv-v0", n_graphs=2, discover_radius=r)
        assert reach_key(r) in params.bank
        if first_params is None:
            first_params = params
    keys = [k for k in params.bank if k.startswith("disc_reach_r")]
    assert len(keys) <= 4, keys
    assert reach_key(radii[-1]) in keys
    # a LIVE env's params keep their own table across later evictions
    # (params hold a shallow bank copy — shared-cache eviction must never
    # silently reroute an existing env to the f32 pairwise fallback)
    assert reach_key(radii[0]) in first_params.bank


def test_shadowed_custom_map_warns(tmp_path, monkeypatch):
    """ADVICE r4 #4: when the bundled maps shadow a DIFFERENT
    grid_sliceN.npy in a lower-priority source (e.g. a user's customized
    checkout), a one-time warning names both paths; identical lower copies
    (the normal reference-checkout case) stay silent."""
    import warnings

    from gym_flock_tpu.envs import maps

    # fake checkout with a custom (different) map file
    d = tmp_path / "gym_flock" / "envs" / "spatial" / "maps"
    d.mkdir(parents=True)
    np.save(d / "grid_slice10.npy", np.ones((4, 4), dtype=bool))

    monkeypatch.setenv("GYM_FLOCK_TPU_MAPS", "")  # re-enable discovery
    monkeypatch.setenv("GYM_FLOCK_REFERENCE", str(tmp_path))
    maps._warned_shadow.clear()
    with pytest.warns(UserWarning, match="shadows a different"):
        hit = maps.find_reference_map(10)
    # the bundled copy still wins; the warning is one-time
    assert "data" in hit
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        maps.find_reference_map(10)

    # identical lower-priority copies (e.g. /root/reference) never warn
    monkeypatch.delenv("GYM_FLOCK_REFERENCE")
    maps._warned_shadow.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        maps.find_reference_map(10)
