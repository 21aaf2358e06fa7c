"""Host-parallel VRP label generation for coverage imitation learning.

The SURVEY §5.8 pipeline, implemented: the device rolls out batched coverage
episodes (greedy behavior policy) while the CPU fans the per-state VRP
solves across a thread pool — ``ctypes`` releases the GIL around the C++
solver call, so threads get real parallelism.  The result is a
(padded obs graph, VRP expert action) batch in exactly the layout
``CoverageImitationTrainer.loss_fn`` consumes, i.e. DAGGER-style
imitation data with the HIGH-QUALITY expert as labeler and the cheap
on-device greedy expert as behavior policy (reference data-gen analog:
coverage.py:800-872 + vrp_solver.py driven by test.py -x).

Labeling is per-state stateless (a fresh solve per visited state,
``horizon=-1`` budget semantics) — the route-cache statefulness of
``CoverageVRPPolicy`` only matters when the expert itself drives the
episode, which is the legacy single-stream path (``compat.make_legacy``).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from gym_flock_tpu.envs.coverage import CoverageEnv, CoverageParams

__all__ = ["collect_vrp_labeled_batch", "vrp_label_states"]


class _StateView:
    """Duck-typed CoverageState over host numpy arrays (the policy only
    reads fields through np.asarray/int)."""

    def __init__(self, graph, robot_loc, visited, discovered, time):
        self.graph = graph
        self.robot_loc = robot_loc
        self.visited = visited
        self.discovered = discovered
        self.time = time


def vrp_label_states(
    params: CoverageParams,
    states: dict,
    mode: str = "or_default",
    workers: Optional[int] = None,
    last_accept: bool = False,
    rot: int = 0,
) -> np.ndarray:
    """VRP expert actions for a flat batch of coverage states.

    ``states``: dict of host arrays with leading axis N —
    ``graph`` [N], ``robot_loc`` [N, R], ``visited`` [N, max_targets],
    ``discovered`` [N, max_targets] (all-ones when not hide_nodes),
    ``time`` [N].  Returns int32 labels [N, R].

    Each state is labeled independently (fresh solve, empty route cache);
    solves run on a thread pool — the C++ solver releases the GIL.
    """
    from gym_flock_tpu.experts.coverage_vrp import CoverageVRPPolicy

    n = int(np.asarray(states["graph"]).shape[0])
    host = {k: np.asarray(v) for k, v in states.items()}

    # hoist the bank leaves the policy reads to host ONCE: the policy does
    # np.asarray(bank[...][g]) per call, which on device arrays would
    # re-transfer the full [G, T, T] cost/predecessor tables per labeled
    # state (megabytes x n states); on numpy arrays it is a free view
    host_bank = dict(params.bank)
    for k in ("n_targets", "graph_cost", "graph_prev", "neighbor_table"):
        host_bank[k] = np.asarray(params.bank[k])
    params_host = params.replace(bank=host_bank)

    def one(i: int) -> np.ndarray:
        policy = CoverageVRPPolicy(
            params_host, horizon=-1, mode=mode,
            last_accept=last_accept, rot=rot,
        )
        sv = _StateView(
            graph=host["graph"][i],
            robot_loc=host["robot_loc"][i],
            visited=host["visited"][i],
            discovered=host["discovered"][i],
            time=host["time"][i],
        )
        return policy(sv).reshape(-1)

    if workers is not None and workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            labels = list(pool.map(one, range(n)))
    else:
        labels = [one(i) for i in range(n)]
    return np.stack(labels).astype(np.int32)


def collect_vrp_labeled_batch(
    env: CoverageEnv,
    params: CoverageParams,
    key: jax.Array,
    n_envs: int,
    n_steps: int,
    mode: str = "or_default",
    workers: Optional[int] = None,
):
    """Device rollout + host-parallel VRP labeling.

    Returns the ``CoverageImitationTrainer`` batch dict (leading axis
    ``n_envs * n_steps``) whose ``label`` entries are VRP expert actions
    for the states the greedy behavior policy visited.  The device
    program is one jitted scan (greedy controller + step, obs captured);
    labeling overlaps nothing here for simplicity — call sites that want
    rollout/labeling overlap can double-buffer two keys.
    """

    @jax.jit
    def roll(key):
        def one(key):
            k_reset, k_scan = jax.random.split(key)
            state, obs = env.reset_env(k_reset, params)

            def body(carry, key_t):
                state, obs = carry
                k1, k2 = jax.random.split(key_t)
                u = env.controller(state, params, key=k1, greedy=True)
                state2, obs2, r, d, _ = env.step_env(k2, state, u, params)
                sample = {
                    "nodes": obs["nodes"],
                    "edges": obs["edges"],
                    "senders": obs["senders"],
                    "receivers": obs["receivers"],
                    # raw state fields for host labeling (pre-step state —
                    # the decision point the obs corresponds to)
                    "graph": state.graph,
                    "robot_loc": state.robot_loc,
                    "visited": state.visited,
                    "discovered": state.discovered,
                    "time": state.time,
                }
                return (state2, obs2), sample

            _, traj = jax.lax.scan(
                body, (state, obs), jax.random.split(k_scan, n_steps)
            )
            return traj

        traj = jax.vmap(one)(jax.random.split(key, n_envs))
        return jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), traj)

    flat = roll(key)
    state_fields = {
        k: flat.pop(k) for k in ("graph", "robot_loc", "visited", "discovered", "time")
    }
    labels = vrp_label_states(params, state_fields, mode=mode, workers=workers)
    flat["label"] = jnp.asarray(labels)
    return flat
