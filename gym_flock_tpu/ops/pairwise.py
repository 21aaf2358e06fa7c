"""Dense pairwise-interaction kernels — the hot ops of every swarm env.

Re-designs the reference's NumPy geometry kernels
(reference gym_flock/envs/spatial/utils.py:8-88 and the per-env
``compute_helpers`` at flocking_relative.py:111-134) as jit/vmap-friendly JAX
functions with static shapes:

* every kernel is O(N^2) dense — at swarm sizes (N ~ 1e2..1e3) dense pairwise
  work is plain elementwise + reduction code that fuses into one XLA program;
* "edge lists" become fixed-size *masked* index arrays (senders, receivers,
  valid-mask) instead of the reference's variable-length ``np.nonzero``
  outputs, so shapes stay static under jit;
* k-NN uses ``jax.lax.top_k`` instead of sklearn/argpartition.

For N large enough that [N, N] arrays no longer belong in device memory, the
fused passes of ``gym_flock_tpu.ops.pallas_flocking`` never materialize them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "pos_diff",
    "pairwise_sq_dists",
    "radius_adjacency",
    "mean_pool_normalize",
    "radius_edges_masked",
    "knn_edges",
    "nodes_within_radius",
]

_INF = jnp.inf


def pos_diff(sender_loc: jax.Array, receiver_loc: Optional[jax.Array] = None) -> jax.Array:
    """All-pairs differences ``sender[i] - receiver[j]`` -> [N, M, D].

    Mirror of reference utils.py:42-57 (``_get_pos_diff``).
    """
    if receiver_loc is None:
        receiver_loc = sender_loc
    return sender_loc[:, None, :] - receiver_loc[None, :, :]


def pairwise_sq_dists(
    diff: jax.Array, fill_diagonal: Optional[float] = None
) -> jax.Array:
    """Squared distances from a diff tensor; optionally fill the diagonal.

    Mirrors the ``r2`` computation + ``np.fill_diagonal(r2, Inf)`` at
    reference flocking_relative.py:114-115.  Only the first two coordinates
    contribute (positions), matching the reference which squares components
    0 and 1 even when the state has 4 per-agent entries.
    """
    r2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    if fill_diagonal is not None:
        n = r2.shape[-1]
        eye = jnp.eye(n, dtype=bool)
        r2 = jnp.where(eye, jnp.asarray(fill_diagonal, r2.dtype), r2)
    return r2


def radius_adjacency(r2: jax.Array, comm_radius2) -> jax.Array:
    """Binary adjacency ``r2 < comm_radius^2`` as float (flocking_relative.py:117)."""
    return (r2 < comm_radius2).astype(r2.dtype)


def mean_pool_normalize(adj: jax.Array) -> jax.Array:
    """Row-normalize adjacency by neighbor count (flocking_relative.py:120-122).

    Rows with zero neighbors divide by 1 (kept identical to reference).
    """
    n_neighbors = jnp.sum(adj, axis=-1, keepdims=True)
    n_neighbors = jnp.where(n_neighbors == 0, jnp.ones_like(n_neighbors), n_neighbors)
    # reciprocal-then-multiply: N divides instead of N^2.  Bitwise identical
    # to adj / n for BINARY adjacency (entries are exactly 0.0 or 1.0:
    # 1*(1/n) == 1/n and 0*(1/n) == 0, and n >= 1 so no inf/nan edge cases).
    return adj * (1.0 / n_neighbors)


def nodes_within_radius(rad, pos1: jax.Array, pos2: jax.Array) -> jax.Array:
    """Mask of pos2 entries with at least one pos1 agent within ``rad``.

    Mirror of reference utils.py:27-39 (``_nodes_within_radius``), including
    its quirk: a node at *exactly* zero distance contributes 0 to the row-sum
    and so does not by itself mark a node as 'seen' (the reference sums
    distances after zeroing those > rad, then tests > 0).
    """
    diff = pos_diff(pos1, pos2)
    r = jnp.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2)
    r = jnp.where(r > rad, 0.0, r)
    return jnp.sum(r, axis=0) > 0  # [M]


def radius_edges_masked(
    rad,
    pos1: jax.Array,
    pos2: Optional[jax.Array] = None,
    self_loops: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Radius graph as a *dense masked* edge set.

    Static-shape replacement for reference utils.py:8-24 (``_get_graph_edges``)
    whose ``np.nonzero`` output length is data-dependent.  Here the edge set
    is the full N x M grid with a boolean validity mask; downstream code
    either consumes the mask directly or compacts on the host at graph-build
    time (graphs are static per episode batch).

    Returns ``(mask[N, M], dist[N, M], diff[N, M, 2], r[N, M])`` where
    ``mask`` marks pairs with ``0 < r <= rad`` (and the diagonal iff
    ``self_loops`` when pos2 is pos1).  Note the reference keeps edges with
    ``r <= rad`` by zeroing ``r > rad`` then taking nonzero — identical
    boundary semantics are preserved.
    """
    # NOTE: the reference's self_loops=True flag has no observable effect —
    # np.nonzero drops r==0 entries (incl. the diagonal) either way
    # (utils.py:18-24) — so the mask below is exact for both settings.
    del self_loops
    diff = pos_diff(pos1, pos2)
    r = jnp.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2)
    mask = (r <= rad) & (r > 0)
    return mask, jnp.where(mask, r, 0.0), diff, r


def knn_edges(
    k: int,
    pos1: jax.Array,
    pos2: Optional[jax.Array] = None,
    self_loops: bool = False,
    allow_nearest: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """k-nearest-neighbor edges per row, as (receiver-index, dist, diff).

    Mirror of reference utils.py:60-88 (``_get_k_edges``):
    * ``allow_nearest=True``  -> the k nearest targets per agent;
    * ``allow_nearest=False`` -> the 2nd..(k+1)-th nearest (drop the single
      closest), implemented exactly as the reference: take k+1 nearest, then
      remove the argmin.

    Uses ``lax.top_k`` on negated distances instead of
    ``np.argpartition``; output is dense [N, k] index/feature arrays rather
    than a flattened variable-length edge list, which is the natural static
    shape for vmap.
    """
    same = pos2 is None
    diff = pos_diff(pos1, pos2)
    r = jnp.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2)
    if same and not self_loops:
        n = r.shape[0]
        r = jnp.where(jnp.eye(n, dtype=bool), _INF, r)

    if allow_nearest:
        neg_top, idx = jax.lax.top_k(-r, k)
    else:
        neg_top, idx = jax.lax.top_k(-r, k + 1)
        # the nearest is the last of the (k+1) in ascending distance == first
        # of top_k(-r); drop it (reference removes argmin from the mask).
        neg_top, idx = neg_top[:, 1:], idx[:, 1:]

    dists = -neg_top
    rows = jnp.arange(pos1.shape[0])[:, None]
    diffs = diff[rows, idx]  # [N, k, D]
    return idx, dists, diffs
