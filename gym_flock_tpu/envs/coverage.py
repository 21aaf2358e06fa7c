"""Coverage / exploration graph-MDP engine — pure-JAX, static shapes.

Batched, jit-compiled re-design of the reference spatial family:

* ``CoverageEnv``      — reference gym_flock/envs/spatial/coverage.py:82-872
* ``CoverageARLEnv``   — reference coverage_arl.py:15-83 (occupancy maps)
* ``CoverageFullEnv``  — reference coverage_full.py:8-17
* ``ExploreEnv``       — reference coverage_explore.py:4-10 (hide_nodes)
* ``ExploreFullEnv``   — reference coverage_explore_full.py:7-17

N robots walk on a road-lattice graph choosing one of ``N_ACTIONS=4`` padded
motion edges per step; reward is newly-visited targets.  The reference's
padded-buffer observation (MAX_NODES/MAX_EDGES, coverage.py:54-56) already
has static shapes and is kept; everything *around* it is re-architected:

* maps/graphs are preprocessed host-side into a :class:`GraphBank`
  (``gym_flock_tpu.envs.coverage_graph``) — per-node neighbor tables replace
  the reference's per-robot ``np.where`` scans over flat edge lists
  (coverage.py:206-232), making action-edge assembly a pure gather;
* the order-dependent two-pass collision resolution (coverage.py:186-201)
  is a vectorized fixed point preserving the reference's sequential
  lower-index-wins semantics exactly (see :func:`_resolve_conflicts`);
* all-pairs hop costs / predecessors are precomputed per graph (exact
  emulation of coverage.py:621-653 on host), so the greedy expert
  (coverage.py:800-826) is pure gathers + masked argmin on device;
* per-episode map regeneration becomes sampling a graph index from the bank.

Observation dict matches the reference's keys and padding conventions
(coverage.py:353-354): ``nodes [max_nodes, n_node_feat]``,
``edges [max_edges, n_edge_feat]``, ``senders``/``receivers [max_edges]``
(-1 = unused), ``step [1, 1]``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from gym_flock_tpu.core import struct

from gym_flock_tpu.core.env import Env, EnvState
from gym_flock_tpu.core.spaces import Box, DictSpace, MultiDiscrete

__all__ = [
    "CoverageParams",
    "CoverageState",
    "CoverageEnv",
    "default_coverage_bank",
    "coverage_factory",
]

MAX_COST = 1000.0
DELTA = 5.5


@struct.dataclass
class CoverageParams:
    """Static configuration + the graph bank (dynamic pytree leaves).

    Defaults mirror reference coverage.py:34-85.
    """

    # --- static ---
    n_robots: int = struct.field(pytree_node=False, default=6)
    max_nodes: int = struct.field(pytree_node=False, default=500)
    n_actions: int = struct.field(pytree_node=False, default=4)
    n_node_feat: int = struct.field(pytree_node=False, default=3)
    episode_length: int = struct.field(pytree_node=False, default=75)
    max_steps: int = struct.field(pytree_node=False, default=75)
    hide_nodes: bool = struct.field(pytree_node=False, default=False)
    collision_checks: bool = struct.field(pytree_node=False, default=True)
    revisit_nodes: bool = struct.field(pytree_node=False, default=False)
    nearby_starts: bool = struct.field(pytree_node=False, default=True)
    nearby_density: int = struct.field(pytree_node=False, default=5)
    # non-default reference feature flags (coverage.py:41-46).
    # USE_NODE_HISTORY needs no state: the reference's history update guard
    # `USE_NODE_HISTORY == 4` is always False for a bool (coverage.py:268,
    # SURVEY.md §5.9e), so the history column is identically zero.
    comm_edges: bool = struct.field(pytree_node=False, default=False)
    last_edge_feature: bool = struct.field(pytree_node=False, default=False)
    # USE_POS_DELTA is broken upstream in BOTH branches — pinned by
    # tests/test_coverage_parity.py: the init write of [E,2] diffs into the
    # N_EDGE_FEAT=1 buffer crashes at coverage.py:594, and with the buffer
    # width patched the un-doubled action_diff cannot concatenate with the
    # doubled action_dist at coverage.py:287.  ``pos_delta`` here is the
    # REPAIRED intended semantics (beyond-reference): edge features become
    # [dx, dy, dist] ([flag, dx, dy, dist] with last_edge_feature) with the
    # reversed tail duplicates carrying negated diffs; motion rows keep raw
    # (unnormalized) values like the dist quirk, tail rows are / res.
    pos_delta: bool = struct.field(pytree_node=False, default=False)
    # hide-nodes discovery-mask routing: None = auto (engage when the bank
    # carries hide_*_onehot operands and the tail-edge radius condition
    # holds — see _hide_mm_active), True/False forces the one-hot
    # matmul / the gather+scatter path
    hide_mm: bool | None = struct.field(pytree_node=False, default=None)
    # largest motion/action edge length in the bank (set by the factory,
    # host-computed); static so _hide_mm_active can compare it against
    # discover_radius with params as a traced jit argument
    max_neighbor_dist: float | None = struct.field(pytree_node=False, default=None)
    # --- dynamic ---
    frac_active_targets: float = 0.5
    res: float = DELTA
    # static (a geometry constant in the reference, coverage.py:335); the
    # hide_mm gate compares it against max_neighbor_dist at trace time.
    # NOTE: static means pytree-STRUCTURE — params with different radii
    # cannot be vmapped/stacked together; sweep via separate instances
    discover_radius: float = struct.field(pytree_node=False, default=4.0 * DELTA)
    comm_radius: float = 100.0  # robot-robot comm range (coverage.py:135)
    # graph bank: dict of stacked arrays (see coverage_graph.build_graph_bank)
    bank: Any = None

    @property
    def max_targets(self) -> int:
        return self.max_nodes - self.n_robots

    @property
    def max_edges(self) -> int:
        return self.max_nodes * self.n_actions

    @property
    def n_action_edges(self) -> int:
        # bidirectional action edges written at the buffer tail each step
        return 2 * self.n_actions * self.n_robots

    @property
    def n_comm_edges(self) -> int:
        # robot-robot comm edge slots (R*(R-1) pairs, masked when out of range)
        return self.n_robots * (self.n_robots - 1) if self.comm_edges else 0

    @property
    def n_edge_feat(self) -> int:
        # [dist] or [last_edge_flag, dist] (reference coverage.py:296-314);
        # pos_delta: [dx, dy, dist] / [flag, dx, dy, dist] (repaired mode)
        base = 3 if self.pos_delta else 1
        return base + (1 if self.last_edge_feature else 0)


@struct.dataclass
class CoverageState(EnvState):
    graph: jax.Array  # int32 bank index
    robot_loc: jax.Array  # [R] int32 target index of each robot
    visited: jax.Array  # [max_targets] float32 (1 = visited)
    discovered: jax.Array  # [max_targets] float32 (hide_nodes mode)
    episode_reward: jax.Array  # float32 accumulator (render/metrics parity)
    last_loc: jax.Array  # [R] int32 pre-move location; -1 after reset


def _safe_gather(vec: jax.Array, idx: jax.Array, fill=0.0) -> jax.Array:
    """vec[idx] with idx == -1 mapping to ``fill`` (NumPy would wrap)."""
    safe = jnp.clip(idx, 0, vec.shape[0] - 1)
    return jnp.where(idx >= 0, vec[safe], jnp.asarray(fill, vec.dtype))


def _packed_greedy_min(cost, g, cur, blocked):
    """``min_t where(blocked, 1024, cost[g, cur, t]) * 8192 + t`` per robot.

    One env (``jax.vmap`` over the batch): ``cost`` [G, T, T], ``g`` the
    env's graph, ``cur`` [R] robot nodes, ``blocked`` [T].  The target index
    rides in the low bits, so one single-value ``min`` gives both the
    nearest cost and the first index attaining it (argmin's tie-break).
    Exact in f32: costs are integers <= 2047 and T <= 8192
    (coverage_graph._cost_pack_marker), so every value is < 2^24.  Decode
    with ``loc = m % 8192`` and ``unreachable = (m - loc) / 8192 >=
    MAX_COST``.
    """
    rows = cost[g, cur].astype(jnp.float32)  # [R, T]
    idx = jnp.arange(blocked.shape[-1], dtype=jnp.float32)
    return jnp.min(jnp.where(blocked[None, :], 1024.0, rows) * 8192.0 + idx, axis=-1)


def _hide_mm_active(params) -> bool:
    """Static predicate: the one-hot discovery-mask path is in use.

    The hide-nodes obs needs per-edge discovery lookups
    (``disc_all[senders]``/``[receivers]``) and a frontier scatter — all
    per-env-index gathers and scatters.  With the bank's ``hide_*_onehot``
    operands (coverage_graph.hide_mm_operands) they become three exact
    one-hot matmuls over the MOTION block only.  On an NVIDIA H100 (700 W)
    the gather path measured faster at ExploreFullEnv-v0 x 512 envs (16
    greedy steps: 23.7 ms vs 35.9 ms, benchmarks/kernel_timings.py); the
    auto default stays on until the benchmark re-decides it.  The fast path
    relies on this: the tail (action) edges need almost no lookups when
    ``max_neighbor_dist <= discover_radius``: every REAL action-edge
    endpoint is at distance (0, discover_radius] of its robot's CURRENT
    node, and the discovery update runs before the masks, so those
    senders/receivers are always discovered — their frontier contribution
    is identically zero, and tail visibility is already forced to 1.  The
    one exception is the SELF-PAD action edge (neighbor_table pads with
    the node itself): by the reference's d > 0 discovery quirk a robot
    does not discover the node it stands on, so that sender can be
    undiscovered and flag the robot's own frontier row — handled by a
    single [R] lookup in the fast branch.  Both comparisons here read
    only static fields, so params may be a traced jit/vmap argument.
    """
    if not params.hide_nodes or params.comm_edges:
        return False
    if "hide_send_onehot" not in params.bank:
        return False
    # the fast path consumes the bank's FULL motion width while the gather
    # path slices to E - n_tail; a user-built bank with a different
    # max_edges split must fall back (shapes are static)
    n_tail = 2 * params.n_actions * params.n_robots
    if params.bank["motion_senders"].shape[1] != params.max_edges - n_tail:
        return False
    # the radius condition is a correctness requirement (tail-edge
    # discovery), not a heuristic — hide_mm=True cannot override it
    ok = (
        params.max_neighbor_dist is not None
        and params.max_neighbor_dist <= params.discover_radius
    )
    if params.hide_mm is not None:
        return params.hide_mm and ok
    return ok


def _resolve_conflicts(cur: jax.Array, chosen: jax.Array, collision_checks: bool):
    """Movement conflict resolution — the reference's two-pass sequential
    procedure (coverage.py:186-201), evaluated as a vectorized fixed point.

    Sequential semantics to preserve exactly: pass 1 lets every robot whose
    choice is its current node claim it; pass 2 walks robots in index order —
    robot i moves to ``chosen[i]`` unless that value already appears in the
    (partially filled) result array, else it stays at ``cur[i]``.  Note the
    quirks this implies, which the fixed point reproduces: a later robot's
    pass-1 stay-claim blocks an earlier mover, and an early mover may take a
    later robot's current node before that robot fails into it (both end on
    the same node — allowed by the reference).

    A robot i resolves in a round when no smaller-indexed robot is still
    pending a claim that could affect ``chosen[i]``; each round resolves at
    least the lowest pending index, so the loop terminates in <= R rounds
    (typically 2-3).  This replaces an R-iteration sequential ``lax.scan`` —
    at R=100 (ExploreFull) the scan's hundred dependent micro-kernels were
    the step bottleneck.
    """
    if not collision_checks:
        return chosen
    R = cur.shape[0]
    idx = jnp.arange(R)
    next0 = jnp.where(chosen == cur, chosen, -1)

    def cond(nl):
        return jnp.any(nl == -1)

    is_stay = next0 >= 0  # pass-1 claims, visible to every robot

    def body(nl):
        pending = nl == -1  # [R]
        j_lt_i = idx[None, :] < idx[:, None]
        # claims robot i would see at its sequential turn: all pass-1 stays
        # plus results of smaller-indexed robots (a resolved j > i mover or
        # failer is NOT visible to i — sequentially it was still -1)
        visible = is_stay[None, :] | (j_lt_i & ~pending[None, :])
        claimed = visible & (nl[None, :] == chosen[:, None])
        definitely_taken = jnp.any(claimed, axis=1)
        # potential future claims from still-pending smaller-indexed robots
        maybe = (
            j_lt_i
            & pending[None, :]
            & ((chosen[None, :] == chosen[:, None]) | (cur[None, :] == chosen[:, None]))
        )
        maybe_taken = jnp.any(maybe, axis=1)

        resolve_now = pending & ~maybe_taken
        outcome = jnp.where(definitely_taken, cur, chosen)
        return jnp.where(resolve_now, outcome, nl)

    return jax.lax.while_loop(cond, body, next0)


class CoverageEnv(Env[CoverageParams, CoverageState]):
    """Graph-coverage MDP over a pre-built graph bank."""

    def default_params(self) -> CoverageParams:
        return CoverageParams(bank=default_coverage_bank())

    # ------------------------------------------------------------------ reset

    def reset_env(self, key: jax.Array, params: CoverageParams):
        R, T = params.n_robots, params.max_targets
        bank_size = params.bank["n_targets"].shape[0]
        k_graph, k_center, k_robots, k_unvis = jax.random.split(key, 4)

        g = jax.random.randint(k_graph, (), 0, bank_size, dtype=jnp.int32)
        n_targets = params.bank["n_targets"][g]
        mask = params.bank["target_mask"][g]

        # start region: full BFS levels around a random center until
        # >= n_robots * nearby_density nodes (reference get_n_nearest,
        # coverage.py:655-673).  Uses the UNCAPPED hop matrix: graph_cost
        # saturates at the horizon and would degenerate the region to the
        # whole map whenever the wanted count exceeds the horizon ball.
        if params.nearby_starts:
            center = jax.random.randint(k_center, (), 0, n_targets)
            d = params.bank["graph_hops"][g, center]  # [T]
            d = jnp.where(mask, d, jnp.inf)
            want = jnp.minimum(R * params.nearby_density, n_targets)
            d_sorted = jnp.sort(d)
            level = d_sorted[want - 1]
            start_region = (d <= level) & mask
        else:
            start_region = mask

        p = start_region.astype(jnp.float32)
        robot_loc = jax.random.choice(
            k_robots, T, shape=(R,), replace=False, p=p / jnp.sum(p)
        ).astype(jnp.int32)

        # random FRAC_ACTIVE unvisited targets (coverage.py:410-417)
        k_active = jnp.floor(n_targets * params.frac_active_targets).astype(jnp.int32)
        scores = jnp.where(
            mask, jax.random.uniform(k_unvis, (T,)), jnp.inf
        )
        rank = jnp.argsort(jnp.argsort(scores))  # rank of each target
        visited = jnp.where(rank < k_active, 0.0, 1.0)

        # tie constant-initialized leaves to the (key-derived) graph index so
        # every state leaf has consistent device-varying type under shard_map
        # (a scan carrying reset-state into step-state otherwise mixes
        # unvarying and varying leaves and fails to type-check)
        vzero = (g * 0).astype(jnp.int32)
        discovered = visited * 0.0

        state = CoverageState(
            time=vzero,
            graph=g,
            robot_loc=robot_loc,
            visited=visited,
            discovered=discovered,
            episode_reward=vzero.astype(jnp.float32),
            last_loc=jnp.full((R,), -1, dtype=jnp.int32) + vzero,  # None in ref
        )
        obs, _, _, state = self._obs_reward(state, params)
        return state, obs

    # ------------------------------------------------------------------- step

    def step_env(self, key, state: CoverageState, action, params: CoverageParams):
        R = params.n_robots
        g = state.graph
        action = jnp.asarray(action).reshape((R,)).astype(jnp.int32)

        cur = state.robot_loc  # [R]
        # fused gather: [R] rows of this graph's neighbor table (materializing
        # bank[g] would stage the whole [T, A] table per env instance).
        # Row gather + in-register action select rather than a 3-index
        # element gather: when the greedy controller ran in the same program
        # it gathered the IDENTICAL [R, A] rows (coverage.py:868), so XLA
        # CSEs the two and the expert rollout runs one gather, not two
        nbr_rows = params.bank["neighbor_table"][g, cur]  # [R, A]
        a_iota = jnp.arange(params.n_actions, dtype=jnp.int32)
        # clip keeps the old gather's clamp semantics for out-of-range
        # actions (a no-match select would silently send the robot to
        # node 0 instead of a neighbor of its own node)
        a_sel = jnp.clip(action, 0, params.n_actions - 1)
        chosen = jnp.sum(
            jnp.where(a_iota[None, :] == a_sel[:, None], nbr_rows, 0), axis=1
        )  # [R] — exactly nbr_rows[r, a_sel[r]] (one selected term per row)

        next_locs = _resolve_conflicts(cur, chosen, params.collision_checks)

        state = state.replace(robot_loc=next_locs.astype(jnp.int32), last_loc=cur)
        key, k_obs = jax.random.split(key)
        obs, reward, done, state = self._obs_reward(state, params, key=k_obs)
        return state, obs, reward, done, {}

    # ----------------------------------------------------------- obs / reward

    def _obs_reward(
        self, state: CoverageState, params: CoverageParams, key=None
    ):
        """Observation graph + reward (reference _get_obs_reward,
        coverage.py:234-364)."""
        R, T, A = params.n_robots, params.max_targets, params.n_actions
        E = params.max_edges
        g = state.graph
        mask = params.bank["target_mask"][g]
        n_targets = params.bank["n_targets"][g]
        cur = state.robot_loc

        visited = state.visited
        if params.revisit_nodes and key is not None:
            # REVISIT_NODES: each visited landmark reverts w.p. 0.005
            # (coverage.py:246-247)
            flip = jax.random.bernoulli(key, 0.005, (T,))
            visited = jnp.where(flip & mask, 0.0, visited)

        # ---- action edges (reference get_action_edges, coverage.py:206-232)
        nbr = params.bank["neighbor_table"][g, cur]  # [R, A] target idx
        nbr_dist = params.bank["neighbor_dist"][g, cur]  # [R, A]
        robots = jnp.repeat(jnp.arange(R, dtype=jnp.int32), A)  # [R*A] global
        nodes_g = (nbr + R).reshape((R * A,))  # global indices
        dist = nbr_dist.reshape((R * A,))

        # bidirectional doubling (coverage.py:259-261), then the buffer-tail
        # write uses senders=action_edges[1], receivers=action_edges[0]
        # (coverage.py:282-283)
        tail_senders = jnp.concatenate([nodes_g, robots])  # [nA]
        tail_receivers = jnp.concatenate([robots, nodes_g])
        tail_dist = jnp.concatenate([dist, dist]) / params.res  # (:292)

        if params.pos_delta:
            # repaired USE_POS_DELTA (see CoverageParams): per-edge position
            # delta pos[sender] - pos[receiver]; the reversed duplicates
            # negate it (upstream never doubles action_diff -> crash at
            # coverage.py:287, pinned in tests)
            tp_pd = params.bank["target_pos"][g]
            nd = (tp_pd[nbr] - tp_pd[cur][:, None, :]).reshape((R * A, 2))
            tail_diff = jnp.concatenate([nd, -nd]) / params.res

        # ---- robot-robot comm edges (COMM_EDGES, coverage.py:271-280):
        # R*(R-1) candidate off-diagonal pairs in np.nonzero row-major order;
        # in-range pairs are COMPACTED to the front of the comm block (the
        # reference's _get_graph_edges returns only the in-range pairs), so
        # the buffer layout matches the reference positionally on any map
        if params.comm_edges:
            target_pos = params.bank["target_pos"][g]
            rp = target_pos[cur]  # [R, 2]
            dmat = jnp.sqrt(
                jnp.sum((rp[:, None, :] - rp[None, :, :]) ** 2, axis=-1)
            )
            ii = jnp.repeat(jnp.arange(R, dtype=jnp.int32), R - 1)
            jj = (
                jnp.arange(R * (R - 1), dtype=jnp.int32) % (R - 1)
            )
            jj = jnp.where(jj >= ii, jj + 1, jj)  # skip the diagonal
            dvals = dmat[ii, jj]
            valid = (dvals > 0) & (dvals <= params.comm_radius)
            n_comm = jnp.sum(valid.astype(jnp.int32))
            # stable compaction: valid pairs first, row-major order preserved
            order = jnp.argsort(jnp.where(valid, 0, 1), stable=True)
            slot = jnp.arange(R * (R - 1)) < n_comm
            comm_senders = jnp.where(slot, ii[order], -1)
            comm_receivers = jnp.where(slot, jj[order], -1)
            comm_dist = jnp.where(slot, dvals[order], 0.0) / params.res
            tail_senders = jnp.concatenate([tail_senders, comm_senders])
            tail_receivers = jnp.concatenate([tail_receivers, comm_receivers])
            tail_dist = jnp.concatenate([tail_dist, comm_dist])
            if params.pos_delta:
                cd = (rp[ii] - rp[jj])[order]
                cd = jnp.where(slot[:, None], cd, 0.0) / params.res
                tail_diff = jnp.concatenate([tail_diff, cd])
            n_tail_used = 2 * A * R + n_comm  # traced: varies per step

        # ---- last-edge flag (LAST_EDGE_FEATURE, coverage.py:296-308):
        # tail edge k flagged when it points INTO robot i from i's pre-move
        # location (last_loc is None -> all zeros after reset)
        if params.last_edge_feature:
            last_g = jnp.where(state.last_loc >= 0, state.last_loc + R, -2)
            is_robot = tail_receivers < R
            safe_recv = jnp.clip(tail_receivers, 0, R - 1)
            last_flag = (
                is_robot & (tail_senders == last_g[safe_recv])
            ).astype(jnp.float32)

        # ---- visited update + reward (coverage.py:265-266, 357-359)
        old_sum = jnp.sum(visited * mask)
        visited = visited.at[cur].set(1.0)
        new_sum = jnp.sum(visited * mask)
        reward = new_sum - old_sum

        # ---- buffers
        n_tail = tail_senders.shape[0]  # nA (+ comm slots), static max
        if params.comm_edges:
            # dynamic tail offset: the reference writes the (action + comm)
            # block flush at the buffer END (coverage.py:320-322), so its
            # start shifts with the per-step comm-edge count.  Positions are
            # selected by a gather over [motion | tail] — static shapes, one
            # extra [E] gather only in this flag mode.
            # (Deviation: rows between the motion block and the tail are
            # zero-features here; the reference leaves STALE features from
            # earlier, longer tails there — senders/receivers are -1 either
            # way, which is what consumers mask on, e.g. unpack_obs
            # coverage.py:719.)
            tail_start = E - n_tail_used  # traced scalar
            M = params.bank["motion_senders"].shape[1]
            pad = E - M
            neg = jnp.full((pad,), -1, dtype=jnp.int32)
            zpad = jnp.zeros((pad,))
            motion_s = jnp.concatenate([params.bank["motion_senders"][g], neg])
            motion_r = jnp.concatenate([params.bank["motion_receivers"][g], neg])
            motion_d = jnp.concatenate([params.bank["motion_dists"][g], zpad])
            p = jnp.arange(E)
            is_tail = p >= tail_start
            idx = jnp.where(is_tail, p - tail_start + E, p)
            senders = jnp.concatenate([motion_s, tail_senders])[idx]
            receivers = jnp.concatenate([motion_r, tail_receivers])[idx]
            dist_col = jnp.concatenate([motion_d, tail_dist])[idx]
            if params.pos_delta:
                # uniform repaired layout [flag?, dx, dy, dist] (motion rows
                # flag 0, raw dist; tail rows already / res)
                valid_m = motion_s >= 0
                tp_pd2 = params.bank["target_pos"][g]
                sp_m = tp_pd2[jnp.clip(motion_s - R, 0, T - 1)]
                rp_m = tp_pd2[jnp.clip(motion_r - R, 0, T - 1)]
                mdiff = jnp.where(valid_m[:, None], sp_m - rp_m, 0.0)
                diffx = jnp.concatenate([mdiff[:, 0], tail_diff[:, 0]])[idx]
                diffy = jnp.concatenate([mdiff[:, 1], tail_diff[:, 1]])[idx]
                cols = [diffx, diffy, dist_col]
                if params.last_edge_feature:
                    cols = [jnp.concatenate([jnp.zeros((E,)), last_flag])[idx]] + cols
                edge_feat = jnp.stack(cols, axis=1)
            elif params.last_edge_feature:
                flag_col = jnp.concatenate(
                    [jnp.zeros((E,)), last_flag]
                )[idx]
                edge_feat = jnp.stack(
                    [
                        jnp.where(is_tail, flag_col, dist_col),
                        jnp.where(is_tail, dist_col, 0.0),
                    ],
                    axis=1,
                )
            else:
                edge_feat = dist_col.reshape((E, 1))
        else:
            motion_senders = params.bank["motion_senders"][g][: E - n_tail]
            motion_receivers = params.bank["motion_receivers"][g][: E - n_tail]
            motion_dists = params.bank["motion_dists"][g][: E - n_tail]
            senders = jnp.concatenate([motion_senders, tail_senders])  # [E]
            receivers = jnp.concatenate([motion_receivers, tail_receivers])
            # motion-edge features are raw distances in column 0
            # (coverage.py:592 does NOT normalize by res, and with
            # LAST_EDGE_FEATURE the tail's dist moves to column 1 while
            # motion rows keep column 0 — quirks)
            if params.pos_delta:
                # uniform repaired layout [flag?, dx, dy, dist]
                valid_m = motion_senders >= 0
                tp_pd2 = params.bank["target_pos"][g]
                sp_m = tp_pd2[jnp.clip(motion_senders - R, 0, T - 1)]
                rp_m = tp_pd2[jnp.clip(motion_receivers - R, 0, T - 1)]
                mdiff = jnp.where(valid_m[:, None], sp_m - rp_m, 0.0)
                motion_cols = jnp.concatenate(
                    [mdiff, motion_dists[:, None]], axis=1
                )
                tail_cols = jnp.concatenate(
                    [tail_diff, tail_dist[:, None]], axis=1
                )
                if params.last_edge_feature:
                    motion_cols = jnp.concatenate(
                        [jnp.zeros((motion_cols.shape[0], 1)), motion_cols], axis=1
                    )
                    tail_cols = jnp.concatenate(
                        [last_flag[:, None], tail_cols], axis=1
                    )
                edge_feat = jnp.concatenate([motion_cols, tail_cols], axis=0)
            elif params.last_edge_feature:
                motion_cols = jnp.stack(
                    [motion_dists, jnp.zeros_like(motion_dists)], axis=1
                )
                tail_cols = jnp.stack([last_flag, tail_dist], axis=1)
                edge_feat = jnp.concatenate([motion_cols, tail_cols], axis=0)
            else:
                edge_feat = jnp.concatenate([motion_dists, tail_dist]).reshape((E, 1))

        # ---- node features (coverage.py:319-329)
        robot_flag = jnp.concatenate(
            [jnp.ones((R,)), jnp.zeros((T,))]
        )
        landmark_flag = jnp.concatenate([jnp.zeros((R,)), mask.astype(jnp.float32)])
        notvisited = jnp.concatenate(
            [jnp.zeros((R,)), (1.0 - visited) * mask]
        )
        cols = [robot_flag, landmark_flag, notvisited]
        # the [max_nodes, nf] nodes buffer is stacked ONCE, after the
        # hide-nodes block has produced the discovery multiplier and the
        # frontier column — the r4 formulation stacked first and then
        # rewrote the whole buffer twice (*= disc_all, .at[:, 3].set),
        # three 47 MB passes per ExploreFull batched step instead of one

        discovered = state.discovered
        out_senders = senders
        if params.hide_nodes:
            # ---- discovery + frontier (coverage.py:334-346)
            from gym_flock_tpu.envs.coverage_graph import reach_key as _rkey

            reach_key = _rkey(params.discover_radius)
            if reach_key in params.bank:
                # static reach-table route (coverage_graph.disc_reach_operand):
                # robots sit ON nodes, so discovery is node occupancy x a
                # per-graph reach relation — one one-hot bf16 matmul instead
                # of the [R, n_all] pairwise sqrt pass (measured ~6 ms of the
                # 24 ms ExploreFull batched step).  Key presence is static;
                # the key embeds the radius so a post-factory override falls
                # back to the pairwise path below.
                Wr = params.bank[reach_key]  # [G*T, T] bf16 0/1
                Gn = params.bank["target_mask"].shape[0]
                occ = jnp.zeros((T,), jnp.bfloat16).at[cur].set(1)
                if Gn == 1:
                    # single-graph bank: the segment placement is identity
                    # (g is always 0) — skip the where/reshape passes
                    occ_seg = occ
                else:
                    occ_seg = (
                        jnp.where(jnp.arange(Gn)[:, None] == g, occ[None, :], 0)
                        .reshape((Gn * T,))
                        .astype(jnp.bfloat16)
                    )
                cnt = jnp.dot(occ_seg, Wr, preferred_element_type=jnp.float32)
                seen_targets = (cnt > 0.0) & mask
            else:
                target_pos_d = params.bank["target_pos"][g]
                robot_pos_d = target_pos_d[cur]
                all_pos = jnp.concatenate([robot_pos_d, target_pos_d], axis=0)
                from gym_flock_tpu.ops.pairwise import nodes_within_radius

                seen = nodes_within_radius(
                    params.discover_radius, robot_pos_d, all_pos
                )
                seen_targets = seen[R:] & mask
            discovered = jnp.maximum(
                discovered, seen_targets.astype(jnp.float32)
            )
            disc_all = jnp.concatenate(
                [jnp.ones((R,)), discovered]
            )  # robots always discovered
            cols = [c * disc_all for c in cols]

            if _hide_mm_active(params):
                # one-hot discovery masks (rationale in _hide_mm_active): the
                # motion-block lookups run as exact one-hot matmuls against
                # batch-invariant operands; tail edges are always discovered
                # by the radius argument, so their frontier contribution is
                # identically zero and their visibility is the forced 1.
                # Per-env [1, G*n_all] rows flatten into one dot under the
                # env-batch vmap.
                Gn = params.bank["target_mask"].shape[0]
                n_all = R + T
                seg = jnp.arange(Gn)[:, None] == g
                if Gn == 1:
                    disc_seg = disc_all.astype(jnp.bfloat16)
                else:
                    disc_seg = (
                        jnp.where(seg, disc_all[None, :], 0.0)
                        .reshape((Gn * n_all,))
                        .astype(jnp.bfloat16)
                    )
                d_send_m = jnp.dot(
                    disc_seg,
                    params.bank["hide_send_onehot"],
                    preferred_element_type=jnp.float32,
                )
                d_recv_m = jnp.dot(
                    disc_seg,
                    params.bank["hide_recv_onehot"],
                    preferred_element_type=jnp.float32,
                )
                if "hide_adj" in params.bank:
                    # node-space frontier (coverage_graph.hide_mm_operands
                    # "hide_adj"): count UNdiscovered in-neighbors directly
                    # over the motion adjacency — n_all/Em (~1/4) of the
                    # edge-space contraction's FLOPs, same boolean
                    if Gn == 1:
                        undisc_seg = (1.0 - disc_all).astype(jnp.bfloat16)
                    else:
                        undisc_seg = (
                            jnp.where(seg, (1.0 - disc_all)[None, :], 0.0)
                            .reshape((Gn * n_all,))
                            .astype(jnp.bfloat16)
                        )
                    cnt_fr = jnp.dot(
                        undisc_seg,
                        params.bank["hide_adj"],
                        preferred_element_type=jnp.float32,
                    )
                    frontier_nodes = (
                        (cnt_fr > 0.0) & (disc_all > 0.0)
                    ).astype(jnp.float32)
                else:
                    # in-edge counts per node (<= N_ACTIONS, bf16-exact) —
                    # kept for banks saved before hide_adj existed
                    fr = jnp.dot(
                        ((1.0 - d_send_m) * d_recv_m).astype(jnp.bfloat16),
                        params.bank["hide_recv_onehot"].T,
                        preferred_element_type=jnp.float32,
                    )
                    frontier_nodes = (
                        jnp.sum(
                            jnp.where(seg, fr.reshape((Gn, n_all)), 0.0), axis=0
                        )
                        > 0.0
                    ).astype(jnp.float32)
                # Robot rows: motion edges never point at robots, so the
                # matmul leaves them 0 — but the SELF-PAD action edges
                # (neighbor_table pads with the node itself) can have an
                # undiscovered sender: nodes_within_radius keeps the
                # reference's d > 0 quirk, so a robot does NOT discover the
                # node it stands on (utils.py:27-39).  Real neighbors are
                # always discovered (0 < dist <= max_neighbor_dist <=
                # discover_radius), so a robot's frontier flag reduces to
                # "has a self-pad slot AND its own node is undiscovered" —
                # one [R] lookup instead of per-edge gathers.
                d_cur = disc_all[cur + R]  # [R]
                robot_frontier = (
                    jnp.any(nbr == cur[:, None], axis=1) & (d_cur == 0.0)
                ).astype(jnp.float32)
                frontier_nodes = jnp.concatenate(
                    [robot_frontier, frontier_nodes[R:]]
                )
                seen_edges = jnp.concatenate(
                    [(d_send_m * d_recv_m)[: E - n_tail], jnp.ones((n_tail,))]
                )
            else:
                d_send = _safe_gather(disc_all, senders, fill=0.0)
                d_recv = _safe_gather(disc_all, receivers, fill=0.0)
                frontier_mask = (1.0 - d_send) * d_recv > 0.0  # [E]
                frontier_nodes = jnp.zeros((R + T,))
                frontier_nodes = frontier_nodes.at[
                    jnp.clip(receivers, 0, R + T - 1)
                ].max(frontier_mask.astype(jnp.float32))
                seen_edges = d_send * d_recv
                # tail (action/comm) edges always visible (coverage.py:343)
                if params.comm_edges:
                    seen_edges = jnp.where(
                        jnp.arange(E) >= tail_start, 1.0, seen_edges
                    )
                else:
                    seen_edges = seen_edges.at[E - n_tail :].set(1.0)
            if params.n_node_feat >= 4:
                # col 3 pre-multiply was zeros, so max(col3*disc, frontier)
                # == frontier exactly (the r4 .at[:, 3].set formulation)
                cols.append(frontier_nodes)
            out_senders = jnp.where(seen_edges > 0, senders, -1)

        if params.n_node_feat >= 4 and len(cols) < 4:
            cols.append(jnp.zeros((R + T,)))
        nodes = jnp.stack(cols[: params.n_node_feat], axis=1)  # [max_nodes, nf]

        # ---- step counter & done (coverage.py:351-357): the obs carries the
        # pre-increment counter; reset's internal _get_obs_reward call means
        # post-reset time is already 1
        step_array = state.time.astype(jnp.float32).reshape((1, 1))
        time = state.time + 1
        done = (time == params.episode_length) | (new_sum >= n_targets)

        obs = {
            "nodes": nodes.astype(jnp.float32),
            "edges": edge_feat.astype(jnp.float32),
            "senders": out_senders.astype(jnp.int32),
            "receivers": receivers.astype(jnp.int32),
            "step": step_array,
        }
        state = state.replace(
            time=time,
            visited=visited,
            discovered=discovered,
            episode_reward=state.episode_reward + reward,
        )
        return obs, reward, done, state

    # ------------------------------------------------------------- controller

    def controller(
        self,
        state: CoverageState,
        params: CoverageParams,
        key: Optional[jax.Array] = None,
        greedy: bool = True,
    ):
        """Greedy nearest-unvisited expert (reference coverage.py:800-826,
        859-871): pick the closest unvisited target by hop cost, then step
        toward it along the precomputed predecessor matrix.  Unreachable ->
        uniform-random action (requires ``key``; defaults to a fixed key).

        The VRP expert (reference vrp_solver.py) is host-side — see
        ``gym_flock_tpu.experts.vrp``.
        """
        R = params.n_robots
        g = state.graph
        if key is None:
            key = jax.random.key(0)
        mask = params.bank["target_mask"][g]
        cur = state.robot_loc

        blocked = (state.visited >= 1.0) | ~mask
        if params.hide_nodes:
            blocked = blocked | (state.discovered <= 0.0)
        if "cost_pack_ok" in params.bank:
            # packed single-value min (coverage_graph._cost_pack_marker):
            # one fused reduce over the gathered rows instead of a variadic
            # argmin plus a second gather for the unreachable test.  Rows
            # come from the bf16 cost copy when the bank carries one (exact
            # integer hops + 1024 for unreachable, half the bytes of the
            # f32 table), the f32 table otherwise.  The gather is cheaper
            # than a one-hot bf16 matmul against the table: 2.6x at
            # Coverage-v0 (R=6) x 8,192 envs on an NVIDIA H100.
            cost = params.bank.get("graph_cost_bf16", params.bank["graph_cost"])
            m = _packed_greedy_min(cost, g, cur, blocked)
            greedy_loc = (m % 8192.0).astype(jnp.int32)
            unreachable = (m - greedy_loc) / 8192.0 >= MAX_COST
        else:
            r = params.bank["graph_cost"][g, cur]  # [R, T]
            r = jnp.where(blocked[None, :], MAX_COST, r)
            greedy_loc = jnp.argmin(r, axis=1)  # [R] target idx
            unreachable = r[jnp.arange(R), greedy_loc] >= MAX_COST

        next_step = params.bank["graph_prev"][g, greedy_loc, cur]  # [R]
        bad = unreachable | (next_step == -1)

        # map next_step to the action index in the robot's neighbor row
        nbr = params.bank["neighbor_table"][g, cur]  # [R, A]
        match = nbr == next_step[:, None]
        u = jnp.argmax(match, axis=1).astype(jnp.int32)

        rand_u = jax.random.randint(key, (R,), 0, params.n_actions, dtype=jnp.int32)
        u = jnp.where(bad, rand_u, u)
        return u.reshape((R, 1))

    # ---------------------------------------------------------------- spaces

    def observation_space(self, params: CoverageParams):
        E = params.max_edges
        return DictSpace(
            {
                "nodes": Box(-jnp.inf, jnp.inf, (params.max_nodes, params.n_node_feat)),
                "edges": Box(-jnp.inf, jnp.inf, (E, params.n_edge_feat)),
                "senders": Box(-1, params.max_nodes, (E,), jnp.int32),
                "receivers": Box(-1, params.max_nodes, (E,), jnp.int32),
                "step": Box(0, params.episode_length, (1, 1)),
            }
        )

    def action_space(self, params: CoverageParams):
        return MultiDiscrete((params.n_actions,) * params.n_robots)


# =============================================================================
# Banks & factories
# =============================================================================

_bank_cache: Dict[tuple, Any] = {}
# bump TOGETHER with coverage_graph.BANK_SCHEMA when GraphSpec/bank fields
# or the build algorithm change (this keys the cache filename; BANK_SCHEMA
# is additionally embedded in + verified against the .npz itself)
_BANK_FORMAT = 7


def default_coverage_bank(
    n_graphs: int = 8,
    n_robots: int = 6,
    max_nodes: Optional[int] = 500,
    horizon: int = 10,
    seed: int = 0,
    kind: str = "coverage",
    **map_kwargs,
):
    """Build (and cache) a bank of coverage graphs.

    ``kind='coverage'`` draws Coverage-v0-style road-lattice maps
    (regenerated per episode in the reference); ``kind='occupancy'`` draws
    sub-windows of an occupancy map (CoverageARL-style, coverage_arl.py:64-82).
    Oversized maps (> max_targets) are redrawn — the reference instead
    crashes on ~2/3 of seeds (SURVEY.md §5.9c).

    ``max_nodes=None`` (only with ``kind='occupancy', full_map=True``) sizes
    the bank to the map: max_targets = the largest component's node count —
    the reference's ``pad_nodes=False`` semantics, where ``max_nodes`` is
    overwritten with the actual agent count (coverage.py:540-541; both
    full-map variants construct with pad_nodes=False).
    """
    keyed_kwargs = dict(map_kwargs)
    if isinstance(keyed_kwargs.get("path"), str):
        # key by map-file CONTENT, not path: a replaced map at the same path
        # must not serve a stale disk-cached bank
        import hashlib as _hl

        with open(keyed_kwargs["path"], "rb") as f:
            keyed_kwargs["path"] = (keyed_kwargs["path"], _hl.sha1(f.read()).hexdigest())
    cache_key = (n_graphs, n_robots, max_nodes, horizon, seed, kind, tuple(sorted(keyed_kwargs.items())))
    if cache_key in _bank_cache:
        return _bank_cache[cache_key]

    # disk cache: occupancy banks take ~15s to build (map load alone is ~12s
    # in the reference, BASELINE.md); cached in utils.cache.bank_cache_dir()
    # keyed by config + a format version (bump _BANK_FORMAT when GraphSpec
    # fields change)
    import hashlib

    from gym_flock_tpu.envs.coverage_graph import load_graph_bank, save_graph_bank
    from gym_flock_tpu.utils.cache import bank_cache_dir

    cache_dir = bank_cache_dir()
    digest = hashlib.sha1(repr((_BANK_FORMAT,) + cache_key).encode()).hexdigest()[:16]
    cache_path = cache_dir / f"bank_{digest}.npz"
    if cache_path.exists():
        try:
            bank = load_graph_bank(str(cache_path))
            _bank_cache[cache_key] = bank
            return bank
        except Exception:
            pass  # corrupt/stale cache: rebuild

    from gym_flock_tpu.envs.coverage_graph import (
        build_graph_bank,
        build_graph_spec,
        generate_coverage_targets,
        targets_from_occupancy,
    )

    rng = np.random.RandomState(seed)
    res = map_kwargs.pop("res", DELTA if kind == "coverage" else 5.0)
    motion_radius = res * 1.2
    min_graph_size = map_kwargs.pop("min_graph_size", 200 if kind == "occupancy" else 2)

    full_map = map_kwargs.pop("full_map", False)
    if full_map and kind != "occupancy":
        raise ValueError("full_map=True is only meaningful for kind='occupancy'")
    if max_nodes is None and not full_map:
        raise ValueError("max_nodes=None (fit-to-map) requires full_map=True")
    max_targets = None if max_nodes is None else max_nodes - n_robots

    specs = []
    if kind == "occupancy":
        from gym_flock_tpu.envs.coverage_graph import _largest_component

        # check_connected=True (every reference occupancy env): trim to the
        # map's largest connected component BEFORE windowing
        # (coverage_arl.py:50-55), so no subwindow can pick up targets from
        # a disconnected fragment of the facility
        all_targets = _largest_component(
            targets_from_occupancy(rng=rng, **map_kwargs), motion_radius
        )

        if full_map:
            # num_subgraphs=1: the whole (already component-trimmed) map is
            # the one static graph (reference coverage_arl.py:83 returns
            # graph_changed=False); build_graph_spec validates the bound
            targets = all_targets
            if targets.shape[0] < min_graph_size:
                raise ValueError(
                    f"full map's largest component has {targets.shape[0]} "
                    f"targets < min_graph_size={min_graph_size}"
                )
            if max_targets is None:  # pad_nodes=False: fit to the map
                max_targets = targets.shape[0]
            specs.append(
                build_graph_spec(targets, max_targets, n_robots, motion_radius, horizon)
            )
            bank = build_graph_bank(specs)
            _bank_cache[cache_key] = bank
            try:
                cache_dir.mkdir(parents=True, exist_ok=True)
                save_graph_bank(str(cache_path), bank)
            except OSError:
                pass
            return bank

        min_xy = all_targets.min(axis=0)
        max_xy = all_targets.max(axis=0)
        sub = (max_xy - min_xy) / 3.0  # num_subgraphs=3 (coverage_arl.py:18)

        while len(specs) < n_graphs:
            start = rng.uniform(low=min_xy, high=max_xy - sub)
            end = start + sub
            sel = np.all((all_targets >= start) & (all_targets < end), axis=1)
            targets = all_targets[sel]
            if targets.shape[0] < min_graph_size:
                continue
            targets = _largest_component(targets, motion_radius)
            if not (min_graph_size <= targets.shape[0] <= max_targets):
                continue
            specs.append(
                build_graph_spec(targets, max_targets, n_robots, motion_radius, horizon)
            )
    else:
        while len(specs) < n_graphs:
            targets = generate_coverage_targets(rng, res=res, **map_kwargs)
            if not (min_graph_size <= targets.shape[0] <= max_targets):
                continue
            specs.append(
                build_graph_spec(targets, max_targets, n_robots, motion_radius, horizon)
            )

    bank = build_graph_bank(specs)
    _bank_cache[cache_key] = bank
    try:
        cache_dir.mkdir(parents=True, exist_ok=True)
        save_graph_bank(str(cache_path), bank)
    except OSError:
        pass  # read-only filesystem: in-memory cache only
    return bank


def coverage_factory(variant: str):
    """Factory for registry entries.  Variants mirror the reference configs:

    * coverage      — Coverage-v0 (coverage.py:82-85)
    * arl           — CoverageARL-v0/-v1 (coverage_arl.py:17-19)
    * full          — CoverageFull-v0 (coverage_full.py:14-17)
    * explore       — ExploreEnv-v0/-v1 (coverage_explore.py:10)
    * explore_full  — ExploreFullEnv-v0 (coverage_explore_full.py:13-17)

    The occupancy variants (everything but ``coverage``) accept
    ``real_map``: ``None`` (default) auto-discovers the reference's real
    ARL facility map (``envs.maps.find_reference_map``) and builds the
    world from it; ``False`` forces the procedural map; ``True`` requires
    the real map (raises when none is found); a string is an explicit path
    to a ``grid_slice``-style occupancy ``.npy``.  On the real map the
    full-map variants size the node budget to the map exactly, matching
    the reference's ``pad_nodes=False`` behavior (coverage.py:540-541) —
    CoverageFull-v0 is a 1,276-node world and ExploreFullEnv-v0 a
    5,759-node world on ``grid_slice10.npy``.
    """

    def factory(n_graphs: int = 8, bank_seed: int = 0, **kwargs):
        env = CoverageEnv()
        real_map = kwargs.pop("real_map", None)
        if real_map not in (None, False) and variant == "coverage":
            raise ValueError(
                "real_map applies to the occupancy variants only; Coverage-v0 "
                "uses road-lattice maps (reference coverage.py:516-527)"
            )
        if variant == "coverage":
            cfg = dict(
                n_robots=6, max_nodes=500, episode_length=75, max_steps=75,
                n_node_feat=3, hide_nodes=False, res=DELTA,
            )
            bank_kind, horizon, peri = "coverage", 10, None
        elif variant == "arl":
            cfg = dict(
                n_robots=4, max_nodes=1000, episode_length=50, max_steps=100000,
                n_node_feat=3, hide_nodes=False, res=5.0,
            )
            bank_kind, horizon, peri = "occupancy", -1, 2.0
        elif variant == "full":
            cfg = dict(
                n_robots=10, max_nodes=1500, episode_length=10000, max_steps=100000,
                n_node_feat=3, hide_nodes=False, res=5.0,
            )
            bank_kind, horizon, peri = "occupancy", 19, 2.0
        elif variant == "explore":
            cfg = dict(
                n_robots=4, max_nodes=1000, episode_length=50, max_steps=100000,
                n_node_feat=4, hide_nodes=True, res=5.0,
            )
            bank_kind, horizon, peri = "occupancy", 19, 2.0
        elif variant == "explore_full":
            cfg = dict(
                n_robots=100, max_nodes=1500, episode_length=50, max_steps=100000,
                n_node_feat=4, hide_nodes=True, res=5.0,
            )
            # reference ExploreFull uses PERIMETER_DELTA=12.0
            # (coverage_explore_full.py:4); with that delta nearly every free
            # cell qualifies, so the procedural map is scaled down to keep
            # the full-map target count near the reference's 1500-node budget
            bank_kind, horizon, peri = "occupancy", 19, 12.0
        else:
            raise ValueError(variant)
        user_max_nodes = "max_nodes" in kwargs
        cfg.update(kwargs)
        bank = cfg.pop("bank", None)
        if bank is not None and real_map not in (None, False):
            # an explicit bank IS the world — a real_map request alongside it
            # cannot be honored, so reject it (same explicitness as the
            # road-lattice rejection above)
            raise ValueError(
                "real_map cannot be combined with an explicit bank=; the bank "
                "already defines the world (convert the map into a bank via "
                "envs.maps / examples/convert_arl_map.py instead)"
            )
        if bank is None:
            map_path = None
            if bank_kind == "occupancy":
                if isinstance(real_map, str):
                    map_path = real_map
                elif real_map is not False:
                    from gym_flock_tpu.envs.maps import find_reference_map

                    map_path = find_reference_map(10)
                    if real_map is True and map_path is None:
                        raise FileNotFoundError(
                            "real_map=True but no grid_slice10.npy found — "
                            "set $GYM_FLOCK_TPU_MAPS or install gym_flock "
                            "(see gym_flock_tpu.envs.maps)"
                        )
            full_map = variant in ("full", "explore_full")
            # pad_nodes=False parity: on a real map the full-map worlds take
            # their node budget from the map itself (unless overridden)
            fit_nodes = full_map and map_path is not None and not user_max_nodes
            bank = default_coverage_bank(
                n_graphs=1 if full_map else n_graphs,
                n_robots=cfg["n_robots"],
                max_nodes=None if fit_nodes else cfg["max_nodes"],
                horizon=horizon,
                seed=bank_seed,
                kind=bank_kind,
                res=cfg["res"],
                full_map=full_map,
                **({"perimeter_delta": peri} if peri is not None else {}),
                **({"path": map_path, "downsample_rate": 10}
                   if map_path is not None else {}),
                **({"map_shape": (48, 42)}
                   if variant == "explore_full" and map_path is None else {}),
            )
            if fit_nodes:
                cfg["max_nodes"] = int(bank["target_mask"].shape[1]) + cfg["n_robots"]
        if cfg.get("hide_nodes") and not cfg.get("comm_edges"):
            # one-hot discovery-mask operands (host-built one-hots; see
            # _hide_mm_active and coverage_graph.hide_mm_operands).
            # max_neighbor_dist is the largest motion/action edge in the
            # bank — neighbor_dist rows pad with self-loops at dist 0, so
            # the plain max is the true bound
            maxd = float(np.max(np.asarray(bank["neighbor_dist"])))
            G_b, Em_b = bank["motion_senders"].shape
            n_all_b = cfg["n_robots"] + bank["target_mask"].shape[1]
            _hide_keys = ("hide_send_onehot", "hide_recv_onehot", "hide_adj")
            _missing = [k for k in _hide_keys if k not in bank]
            if _missing and (
                2 * G_b * n_all_b * Em_b * 2 <= 512 * 1024 * 1024
            ):
                from gym_flock_tpu.envs.coverage_graph import hide_mm_operands

                # in place: default_coverage_bank memoizes the dict, so the
                # operands are built once per bank, not once per make();
                # only the MISSING keys are built (a pre-hide_adj cached
                # bank upgrade must not rebuild the big edge one-hots)
                bank.update(
                    hide_mm_operands(bank, cfg["n_robots"], want=_missing)
                )
            # static discovery-reach table (one one-hot matmul replaces the
            # per-step [R, n_all] pairwise sqrt pass); keyed by radius so a
            # post-factory discover_radius override falls back cleanly
            disc_r = cfg.get(
                "discover_radius", CoverageParams.__dataclass_fields__[
                    "discover_radius"].default
            )
            T_b = bank["target_mask"].shape[1]
            from gym_flock_tpu.envs.coverage_graph import (
                disc_reach_operand,
                reach_key,
            )

            if (
                reach_key(disc_r) not in bank
                and G_b * T_b * T_b * 2 <= 256 * 1024 * 1024
            ):
                # cap device residency (ADVICE r4 #3): the memoized bank
                # would otherwise accumulate one [G*T,T] bf16 table per
                # distinct radius for the process lifetime.  Keep at most
                # _MAX_REACH_TABLES; evict oldest-inserted first.  Safe:
                # every live env's params hold their OWN shallow bank dict
                # (below), so eviction here only shrinks the shared cache —
                # it can never change an existing env's routing.
                _MAX_REACH_TABLES = 4
                have = [k for k in bank if k.startswith("disc_reach_r")]
                for k in have[: max(0, len(have) - (_MAX_REACH_TABLES - 1))]:
                    del bank[k]
                bank.update(disc_reach_operand(bank, float(disc_r)))
            cfg.setdefault("max_neighbor_dist", maxd)
        # params get their OWN shallow dict (arrays shared): the memoized
        # bank is a process-wide cache whose disc_reach_* keys are
        # EVICTABLE (cap above) — a live env must keep its reach table
        # across re-traces regardless of how many radii later make() calls
        # sweep, or the same env would silently switch to the f32 pairwise
        # fallback (which legitimately disagrees at distance==radius ties)
        params = CoverageParams(bank=dict(bank), **cfg)
        if params.comm_edges:
            # the comm slots shrink the motion-edge region beyond what
            # build_graph_spec validated (the reference instead asserts
            # 'Increase MAX_EDGES' at runtime, coverage.py:288)
            max_motion = int(np.max(np.asarray(bank["n_motion_edges"])))
            room = params.max_edges - params.n_action_edges - params.n_comm_edges
            if max_motion > room:
                raise ValueError(
                    f"comm_edges=True reserves {params.n_comm_edges} tail slots "
                    f"but a bank graph has {max_motion} motion edges > {room}; "
                    "raise max_nodes"
                )
        return env, params

    return factory
