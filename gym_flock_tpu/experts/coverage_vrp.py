"""Host-side VRP expert policy for the coverage envs.

Reproduces the reference expert pipeline (reference coverage.py:800-872 +
vrp_solver.py:15-58): formulate a depot-augmented vehicle routing problem
over the unvisited targets, solve it natively
(``gym_flock_tpu.experts.vrp``, replacing OR-Tools), cache the per-robot
waypoint routes, and on every step map the next waypoint to a discrete
action through the precomputed predecessor matrix.

This is deliberately host-side: the solver is sequential combinatorial
search (the reference's is too — in-process C++ behind SWIG).  For bulk
on-device rollouts use the greedy expert (``CoverageEnv.controller``);
use this policy to generate the higher-quality imitation labels, batched
across episodes on CPU while the device rolls out.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from gym_flock_tpu.envs.coverage import MAX_COST, CoverageParams, CoverageState
from gym_flock_tpu.experts.vrp import solve_vrp_raw

__all__ = ["CoverageVRPPolicy", "create_vrp_problem"]

PENALTY_MULTIPLIER = 500.0  # reference vrp_solver.py:12


def create_vrp_problem(
    graph_cost: np.ndarray,
    visited: np.ndarray,
    discovered: Optional[np.ndarray],
    robot_loc: np.ndarray,
    n_targets: int,
):
    """Depot-augmented time matrix + penalties (reference vrp_solver.py:15-58)."""
    init_loc = np.asarray(robot_loc)

    need = (visited[:n_targets] == 0).astype(np.float64)
    if discovered is not None:
        need = need * (discovered[:n_targets] != 0)
    penalties = np.concatenate(([0.0], need * PENALTY_MULTIPLIER))

    dist = np.array(graph_cost[:n_targets, :n_targets], dtype=np.float64)
    fill = np.ones(n_targets)
    fill[init_loc] = 0
    ignore = np.where((visited[:n_targets] != 0) & (fill != 0))[0]
    dist[ignore, :] = PENALTY_MULTIPLIER
    dist[:, ignore] = PENALTY_MULTIPLIER

    from_depot = np.full((1, n_targets), 100000.0)
    from_depot[:, init_loc] = 0.0
    to_depot = np.zeros((n_targets + 1, 1))
    dist = np.vstack((from_depot, dist))
    dist = np.hstack((to_depot, dist))
    return dist, penalties, init_loc + 1  # node ids shifted by depot


class CoverageVRPPolicy:
    """Stateful expert mirroring ``CoverageEnv.controller(greedy=False)``.

    Keeps the per-robot cached solution between steps, re-solving when the
    cache is exhausted or when a rolling horizon is active
    (reference coverage.py:833-837).
    """

    def __init__(self, params: CoverageParams, horizon: int = -1,
                 mode: str = "or_default", strict: bool = False,
                 last_accept: bool = False, rot: int = 0):
        self.params = params
        self.horizon = horizon
        # "or_default" = the reference pipeline (PATH_CHEAPEST_ARC + OR-Tools
        # default greedy-descent local search); "improve" = best solution
        # quality; "cheapest_arc" = construction only
        # (see experts.vrp.solve_vrp_raw)
        self.mode = mode
        # descent-path perturbation probes (or_default only; see
        # experts.vrp.solve_vrp_raw) — used to measure the DOWNSTREAM
        # consequence of the OR-Tools enumeration-order ambiguity by
        # training on probe labels (VERDICT r4 next #4)
        self.last_accept = last_accept
        self.rot = rot
        # strict: reproduce the reference's solution-decode asserts
        # (vrp_solver.py:144-146 — every vehicle's first stop is its own
        # init location; an empty route fails the same assert), raising
        # AssertionError instead of degrading to greedy/random.  The
        # reference driver catches this and restarts the episode
        # (test.py:53-59) — see examples/run_coverage.py --strict-expert.
        self.strict = strict
        self.cached: Optional[List[List[int]]] = None
        self._rng = np.random.RandomState(0)

    def reset(self):
        self.cached = None

    def __call__(self, state: CoverageState) -> np.ndarray:
        p = self.params
        R = p.n_robots
        g = int(state.graph)
        bank = p.bank
        n_targets = int(np.asarray(bank["n_targets"][g]))
        graph_cost = np.asarray(bank["graph_cost"][g])
        graph_prev = np.asarray(bank["graph_prev"][g])
        nbr = np.asarray(bank["neighbor_table"][g])
        visited = np.asarray(state.visited)
        discovered = np.asarray(state.discovered) if p.hide_nodes else None
        cur = np.asarray(state.robot_loc)

        # greedy fallback targets (reference coverage.py:814-826)
        r = graph_cost[cur, :].copy()
        blocked = (visited >= 1.0).copy()
        if discovered is not None:
            blocked |= discovered <= 0.0
        r[:, blocked[: r.shape[1]]] = MAX_COST
        r[:, n_targets:] = MAX_COST
        greedy_loc = np.argmin(r, axis=1)
        for i in range(R):
            if r[i, greedy_loc[i]] >= MAX_COST:
                greedy_loc[i] = -1

        # (re-)solve the VRP (reference coverage.py:833-837)
        if self.cached is None or self.horizon > -1:
            if self.horizon > -1:
                budget = min(
                    self.horizon, p.episode_length - int(np.asarray(state.time))
                )
            else:
                budget = p.episode_length
            tm, pen, init = create_vrp_problem(
                graph_cost, visited, discovered, cur, n_targets
            )
            routes = solve_vrp_raw(
                tm, pen, init, float(budget), mode=self.mode,
                last_accept=self.last_accept, rot=self.rot,
            )
            if self.strict:
                for i, route in enumerate(routes):
                    assert route, "First stop is not an initial position"
                    assert route[0] == int(init[i]), (
                        "First stop is not an initial position"
                    )
            # depot-node ids -> target indices
            self.cached = [[n - 1 for n in route] for route in routes]

        # follow cached waypoints (reference coverage.py:839-857)
        next_loc = np.zeros((R,), dtype=int)
        for i in range(R):
            sol = self.cached[i]
            if len(sol) > 1:
                if cur[i] == sol[0]:
                    self.cached[i] = sol = sol[1:]
                next_loc[i] = sol[0]
            elif len(sol) == 1:
                if cur[i] == sol[0]:
                    self.cached[i] = []
                    next_loc[i] = 0  # mirrors reference leaving 0 in next_loc
                else:
                    next_loc[i] = sol[0]
            else:
                next_loc[i] = greedy_loc[i]

        # waypoint -> action index via predecessors (reference :859-871)
        u = np.zeros((R, 1), dtype=np.int32)
        for i in range(R):
            if next_loc[i] == -1 or graph_prev[next_loc[i], cur[i]] == -1:
                u[i] = self._rng.choice(p.n_actions)
            else:
                nxt = graph_prev[next_loc[i], cur[i]]
                matches = np.where(nbr[cur[i]] == nxt)[0]
                u[i] = matches[0]
        return u
