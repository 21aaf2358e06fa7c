"""Block-sparse flocking reductions: cell-list pruning for large swarms.

The dense pairwise pass is O(N^2), but a constant-density swarm has O(1)
neighbors inside ``comm_radius`` (the reference resets ~1 agent per unit
area, flocking/utils.py:23-30) — at N=16k the dense kernel spends >99% of
its pair tests on agents provably out of range.  This module prunes at
BLOCK granularity, a cell list without per-agent gathers: whole
[128, 128] tiles are skipped, and the tiles that run load contiguous
128-agent column blocks.

Pipeline (all static shapes, fully jittable):
  1. Hilbert-sort agents: quantize positions to ``comm_radius`` cells and
     order along a Hilbert curve — the curve is continuous, so each
     128-agent block covers one compact connected patch (Z-order's
     quadrant jumps produce half-domain bboxes; see morton_order).
  2. Block bounding boxes -> candidate table: row block i only interacts
     with column blocks whose bbox is within ``comm_radius`` of its own
     (bbox distance is a lower bound on the pairwise distance, so pruning
     is EXACT — identical adjacency, gradients, and degree as the dense
     kernel; only float summation order differs).  Candidates compact into
     a static [n_blocks, K] table.
  3. The table drives the cross-block channel sums over only the listed
     pairs: on the GPU a Pallas kernel (Triton route) whose programs load
     only their listed column blocks, elsewhere an XLA scan over the K
     slots; padding slots are skipped.
  4. Results scatter back through the inverse permutation.

Capacity: a row with more than K in-range blocks OVERFLOWS; the result
carries an ``overflow`` flag and :func:`flocking_sums_sparse` falls back
to the dense kernel for that batch element via ``lax.cond`` — correctness
never depends on the capacity heuristic.

Reference semantics: channel layout identical to ``ops.pallas_flocking``
(core set, flocking_relative.py:111-134 + :214-226).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gym_flock_tpu.ops.pallas_flocking import N_OUT

__all__ = [
    "morton_order",
    "hilbert_order",
    "block_pair_table",
    "flocking_sums_sparse",
    "VerletState",
    "verlet_build",
    "flocking_sums_sparse_verlet",
    "sparse_reset_accept",
    "adjacency_matmul_sparse",
    "khop_aggregate_sparse",
]

BLOCK = 128


def _part1by1(v: jax.Array) -> jax.Array:
    """Interleave zeros between the low 16 bits of ``v`` (Morton helper)."""
    v = v & 0x0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_order(x: jax.Array, cell) -> jax.Array:
    """Permutation sorting agents along a Morton (Z-order) curve.

    ``x``: [N, >=2] agent states; ``cell``: quantization pitch (the comm
    radius).  Kept for reference/tests; :func:`hilbert_order` is what the
    sparse pipeline uses — Z-order JUMPS at quadrant boundaries, so a
    128-agent chunk straddling a major split gets a bbox spanning half the
    domain (measured: max 85 candidate blocks at N=65k vs ~17 for
    Hilbert), defeating the bbox pruning.
    """
    q = jnp.floor(x[:, :2] / cell).astype(jnp.int32)
    q = q - jnp.min(q, axis=0)  # non-negative; 16 bits each
    q = jnp.minimum(q, 0xFFFF)
    code = _part1by1(q[:, 0]) | (_part1by1(q[:, 1]) << 1)
    return jnp.argsort(code)


_HILBERT_BITS = 16


def hilbert_order(x: jax.Array, cell) -> jax.Array:
    """Permutation sorting agents along a Hilbert curve.

    The Hilbert curve is CONTINUOUS: consecutive curve positions are
    adjacent cells, so every contiguous 128-agent block covers one compact
    connected patch — the property the bbox pruning of
    :func:`block_pair_table` needs.  Standard xy->d bit transform
    (unrolled over 16 bit levels, pure int32 vector ops).
    """
    q = jnp.floor(x[:, :2] / cell).astype(jnp.int32)
    q = q - jnp.min(q, axis=0)
    q = jnp.minimum(q, (1 << _HILBERT_BITS) - 1)
    hx, hy = q[:, 0], q[:, 1]
    # d < 4^16 = 2^32: uint32 holds it exactly (and s*s*3 < 2^32)
    d = jnp.zeros_like(hx, dtype=jnp.uint32)
    s = 1 << (_HILBERT_BITS - 1)
    while s > 0:
        rx = ((hx & s) > 0).astype(jnp.int32)
        ry = ((hy & s) > 0).astype(jnp.int32)
        d = d + jnp.uint32(s) * jnp.uint32(s) * ((3 * rx) ^ ry).astype(jnp.uint32)
        # rotate quadrant so the sub-curve orientation matches
        swap = ry == 0
        flip = swap & (rx == 1)
        hx_f = jnp.where(flip, s - 1 - hx, hx)
        hy_f = jnp.where(flip, s - 1 - hy, hy)
        hx, hy = (
            jnp.where(swap, hy_f, hx_f),
            jnp.where(swap, hx_f, hy_f),
        )
        s //= 2
    return jnp.argsort(d)


def block_pair_table(xs: jax.Array, comm_radius, k_max: int, skin=0.0):
    """Candidate column blocks per row block, from bounding-box distance.

    ``xs``: [N, 4] curve-sorted agent states (see hilbert_order), N a
    multiple of BLOCK.
    Returns ``(table [n_b, k_max] int32, overflow bool)``; padding slots
    are -1.  bbox separation > comm_radius proves every cross pair is out
    of range (and the gradient cutoff r2 > comm_radius is implied for
    r >= 1 radii... the Turner cutoff compares r^2 against comm_radius
    itself (reference quirk, flocking_relative.py:225), i.e. reaches
    sqrt(comm_radius) > comm_radius for radii < 1 — the pruning distance
    uses max(comm_radius, sqrt(comm_radius)) so both cutoffs are covered).

    ``skin`` expands the pruning reach so the table stays a SUPERSET of
    the in-range block pairs while every agent remains within ``skin/2``
    of where it was when the table was built (Verlet-list slack: a pair
    can close by at most 2 * skin/2 = skin).  Measured at N=65k, density
    1/unit^2: skin = comm_radius adds only ~2% tile work — blocks span
    ~11 units, so the bbox test barely moves.
    """
    n = xs.shape[0]
    n_b = n // BLOCK
    pos = xs[:, :2].reshape(n_b, BLOCK, 2)
    lo = jnp.min(pos, axis=1)  # [n_b, 2]
    hi = jnp.max(pos, axis=1)
    # separation along each axis between bbox i and bbox j
    sep = jnp.maximum(lo[:, None, :] - hi[None, :, :], lo[None, :, :] - hi[:, None, :])
    sep = jnp.maximum(sep, 0.0)
    dist2 = jnp.sum(sep * sep, axis=-1)  # [n_b, n_b] lower bound on pair dist^2
    reach = jnp.maximum(comm_radius, jnp.sqrt(comm_radius)) + skin
    cand = dist2 <= reach * reach  # bbox test is exact pruning

    counts = jnp.sum(cand, axis=1)
    overflow = jnp.any(counts > k_max)
    # compact candidate js to the front of each row (stable order)
    order = jnp.argsort(jnp.where(cand, 0, 1), axis=1, stable=True)  # [n_b, n_b]
    slot = jnp.arange(n_b)[None, :] < counts[:, None]
    packed = jnp.where(slot, order, -1)[:, :k_max]
    return packed.astype(jnp.int32), overflow


def _block_sums_tile(xr, xc, row_off, col_off, comm_radius, comm_radius2,
                     expert=False):
    """Core-channel sums of one [BLOCK, BLOCK] tile (XLA; mirrors
    ops.pallas_flocking.flocking_sums_block channels 0..8).  ``expert`` adds
    the adjacency-masked gradient sums at channels 10/11 (decentralized
    Turner expert; channel 9 — min-r2 — is not part of the sparse contract
    and stays zero)."""
    row_ids = row_off + jnp.arange(BLOCK)
    col_ids = col_off + jnp.arange(BLOCK)
    dx = xr[:, 0, None] - xc[None, :, 0]
    dy = xr[:, 1, None] - xc[None, :, 1]
    dvx = xr[:, 2, None] - xc[None, :, 2]
    dvy = xr[:, 3, None] - xc[None, :, 3]
    r2 = dx * dx + dy * dy
    r2 = jnp.where(row_ids[:, None] == col_ids[None, :], jnp.inf, r2)
    adj = (r2 < comm_radius2).astype(xr.dtype)
    inv = 1.0 / r2
    inv2 = inv * inv
    gfac = jnp.where(r2 > comm_radius, 0.0, 2.0 * inv * (1.0 - inv))
    return jnp.stack(
        [
            jnp.sum(dvx * adj, axis=1),
            jnp.sum(dx * inv2 * adj, axis=1),
            jnp.sum(dx * inv * adj, axis=1),
            jnp.sum(dvy * adj, axis=1),
            jnp.sum(dy * inv2 * adj, axis=1),
            jnp.sum(dy * inv * adj, axis=1),
            jnp.sum(dx * gfac, axis=1),
            jnp.sum(dy * gfac, axis=1),
            jnp.sum(adj, axis=1),
        ]
        + (
            [
                jnp.zeros((BLOCK,), xr.dtype),  # ch9 slot (no min-r2)
                jnp.sum(dx * gfac * adj, axis=1),
                jnp.sum(dy * gfac * adj, axis=1),
            ]
            if expert
            else []
        ),
        axis=1,
    )  # [BLOCK, 9 or 12]


def _sparse_sums_sorted(xs: jax.Array, table: jax.Array, comm_radius, comm_radius2,
                        expert=False):
    """Channel sums over the listed block pairs only (sorted order).

    ``xs`` [N, 4] curve-sorted (see hilbert_order), ``table`` [n_b, k_max].
    XLA formulation:
    vmap over row blocks, scan over the k_max candidate slots with
    dynamic-slice loads of column blocks (whole contiguous 128-row blocks,
    one coalesced load each).
    """
    n = xs.shape[0]
    n_b = n // BLOCK
    xb = xs.reshape(n_b, BLOCK, 4)

    def one_row(i, row):
        def body(acc, j):
            valid = j >= 0
            jc = jnp.maximum(j, 0)
            xc = jax.lax.dynamic_slice(
                xs, (jc * BLOCK, jnp.zeros((), jc.dtype)), (BLOCK, 4)
            )
            t = _block_sums_tile(
                row, xc, i * BLOCK, jc * BLOCK, comm_radius, comm_radius2,
                expert=expert,
            )
            return acc + jnp.where(valid, t, 0.0), None

        nc = 12 if expert else 9
        acc0 = jnp.zeros((BLOCK, nc), xs.dtype)
        acc, _ = jax.lax.scan(body, acc0, table[i])
        return acc

    out = jax.vmap(one_row)(jnp.arange(n_b), xb)  # [n_b, BLOCK, nc]
    nc = out.shape[-1]
    out = out.reshape(n, nc)
    return jnp.concatenate([out, jnp.zeros((n, N_OUT - nc), xs.dtype)], axis=1)


_TILE_ROWS = 32  # row agents per kernel program
_TILE_COLS = 32  # column agents per inner step


def _table_sums_kernel(scal_ref, table_ref, rx_ref, ry_ref, rvx_ref, rvy_ref,
                       cx_ref, cy_ref, cvx_ref, cvy_ref, out_ref, *, expert):
    """One program: ``_TILE_ROWS`` sorted agents against every 128-agent
    column block its row block's table lists (valid slots first, -1 after);
    the channel sums stay in registers and are stored channel-major."""
    bi = rx_ref.shape[0]
    cr, cr2 = scal_ref[0], scal_ref[1]
    rx, ry, rvx, rvy = rx_ref[...], ry_ref[...], rvx_ref[...], rvy_ref[...]
    rid = pl.program_id(1) * bi + jnp.arange(bi, dtype=jnp.int32)
    n_slots = jnp.sum((table_ref[...] >= 0).astype(jnp.int32))

    def chunk(start, acc):
        cols = pl.ds(start, _TILE_COLS)
        dx = rx[:, None] - cx_ref[cols][None, :]
        dy = ry[:, None] - cy_ref[cols][None, :]
        dvx = rvx[:, None] - cvx_ref[cols][None, :]
        dvy = rvy[:, None] - cvy_ref[cols][None, :]
        cid = start + jnp.arange(_TILE_COLS, dtype=jnp.int32)
        r2 = dx * dx + dy * dy
        r2 = jnp.where(rid[:, None] == cid[None, :], jnp.inf, r2)
        adj = (r2 < cr2).astype(jnp.float32)
        inv = 1.0 / r2
        inv2 = inv * inv
        gfac = jnp.where(r2 > cr, 0.0, 2.0 * inv * (1.0 - inv))
        terms = [
            dvx * adj, dx * inv2 * adj, dx * inv * adj,
            dvy * adj, dy * inv2 * adj, dy * inv * adj,
            dx * gfac, dy * gfac, adj,
        ]
        if expert:
            terms += [dx * gfac * adj, dy * gfac * adj]
        return tuple(a + jnp.sum(t, axis=1) for a, t in zip(acc, terms))

    def slot(s, acc):
        base = table_ref[s] * BLOCK
        for c in range(BLOCK // _TILE_COLS):
            acc = chunk(base + c * _TILE_COLS, acc)
        return acc

    zero = jnp.zeros((bi,), jnp.float32)
    acc = jax.lax.fori_loop(0, n_slots, slot, (zero,) * (11 if expert else 9))
    # channel layout of ops.pallas_flocking; 9 (min-r2) is not in the
    # sparse contract and stays zero
    chans = list(acc[:9]) + ([zero, acc[9], acc[10]] if expert else [])
    for c in range(N_OUT):
        out_ref[c, :] = chans[c] if c < len(chans) else zero


def _table_sums_triton(xs, table, comm_radius, comm_radius2, expert,
                       interpret=False):
    """Table-driven channel sums through Pallas' Triton route.

    ``xs`` [B, N, 4] curve-sorted swarms (N a multiple of 128), ``table``
    [B, N/128, k] candidate column blocks.  One program per 32 sorted
    agents; it loads only the column blocks its table row lists, so the
    cell-list indirection is a per-program address, not a gather."""
    b, n, _ = xs.shape
    slots = pl.next_power_of_2(table.shape[-1])
    table = jnp.pad(table.astype(jnp.int32), ((0, 0), (0, 0), (0, slots - table.shape[-1])),
                    constant_values=-1)
    parts = [xs[:, :, c].astype(jnp.float32) for c in range(4)]
    scal = jnp.stack([jnp.asarray(comm_radius, jnp.float32),
                      jnp.asarray(comm_radius2, jnp.float32)])
    row = pl.BlockSpec((None, _TILE_ROWS), lambda e, i: (e, i))
    col = pl.BlockSpec((None, n), lambda e, i: (e, 0))
    per_block = BLOCK // _TILE_ROWS
    out = pl.pallas_call(
        functools.partial(_table_sums_kernel, expert=expert),
        grid=(b, n // _TILE_ROWS),
        in_specs=[pl.BlockSpec((2,), lambda e, i: (0,)),
                  pl.BlockSpec((None, None, slots), lambda e, i: (e, i // per_block, 0))]
        + [row] * 4 + [col] * 4,
        out_specs=pl.BlockSpec((None, N_OUT, _TILE_ROWS), lambda e, i: (e, 0, i)),
        out_shape=jax.ShapeDtypeStruct((b, N_OUT, n), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="flocking_sums_sparse",
    )(scal, table, *parts, *parts)
    return jnp.swapaxes(out, 1, 2).astype(xs.dtype)


def _table_sums(xs, table, comm_radius, comm_radius2, expert):
    """Channel sums over the listed block pairs of sorted swarms ([B, N, 4],
    [B, n_b, k]): the Triton kernel on the GPU, the XLA scan elsewhere."""
    if jax.default_backend() == "gpu":
        return _table_sums_triton(xs, table, comm_radius, comm_radius2, expert)
    return jax.vmap(
        lambda xsi, tablei: _sparse_sums_sorted(
            xsi, tablei, comm_radius, comm_radius2, expert=expert
        )
    )(xs, table)


def _sparse_path_batched(xs, perm, table, comm_radius, comm_radius2, expert):
    """Table-driven channel sums in sorted order, scattered back.

    All operands batched ([B, N, 4] / [B, N] / [B, n_b, k]); shared by
    :func:`_flocking_sums_sparse_impl` and the Verlet pass so the two can
    never diverge.
    """
    n = xs.shape[1]
    out_sorted = _table_sums(xs, table, comm_radius, comm_radius2, expert)

    def unsort(permi, outi):
        inv = (
            jnp.zeros((n,), jnp.int32)
            .at[permi]
            .set(jnp.arange(n, dtype=jnp.int32))
        )
        return outi[inv]

    return jax.vmap(unsort)(perm, out_sorted)


def _dense_path_batched(xb, comm_radius, comm_radius2, expert):
    """Dense fallback with the sparse channel contract ([B, N, 4])."""
    from gym_flock_tpu.ops.pallas_flocking import flocking_sums, flocking_sums_block

    if expert:
        # "full" includes the masked-grad channels 10/11; ch9 (min-r2)
        # is zeroed — it is not part of the sparse contract
        out = flocking_sums_block(xb, xb, 0, 0, comm_radius, comm_radius2)
        return out.at[..., 9].set(0.0)
    return flocking_sums(xb, comm_radius, comm_radius2)


def _flocking_sums_sparse_impl(
    x: jax.Array,
    comm_radius,
    comm_radius2,
    k_max: int = 16,
    channels: str = "core",
):
    if channels not in ("core", "expert"):
        # the DENSE kernels' vocabulary is {"core", "full"}; silently
        # treating "full" as core would zero the masked-grad channels
        raise ValueError(
            f"sparse channels must be 'core' or 'expert', got {channels!r}"
        )
    expert = channels == "expert"

    squeeze = x.ndim == 2
    xb = x[None] if squeeze else x
    n = xb.shape[1]
    assert n % BLOCK == 0, f"N must be a multiple of {BLOCK} (pad the swarm)"

    def prep(xi):
        perm = hilbert_order(xi, comm_radius)
        xs = xi[perm]
        table, overflow = block_pair_table(xs, comm_radius, k_max)
        return xs, perm, table, overflow

    xs, perm, table, overflow = jax.vmap(prep)(xb)

    def sparse_path(operands):
        xs_, perm_, table_ = operands
        return _sparse_path_batched(
            xs_, perm_, table_, comm_radius, comm_radius2, expert
        )

    def dense_path(operands):
        return _dense_path_batched(xb, comm_radius, comm_radius2, expert)

    # the predicate is a batch-wide SCALAR: under vmap a per-env cond
    # lowers to a select that executes BOTH paths for every env — one
    # pathological env would silently buy the whole batch the dense pass
    # anyway, so overflow falls back for the batch as a real branch
    out = jax.lax.cond(jnp.any(overflow), dense_path, sparse_path, (xs, perm, table))
    return out[0] if squeeze else out


def _make_sparse_vmappable(k_max, channels):
    kw = dict(k_max=k_max, channels=channels)

    @jax.custom_batching.custom_vmap
    def f(x, scal):
        return _flocking_sums_sparse_impl(x, scal[0], scal[1], **kw)

    @f.def_vmap
    def rule(axis_size, in_batched, x, scal):
        # route vmap to the NATIVE batch handling: the overflow fallback
        # stays a real scalar-predicate branch.  Vmapping the plain form
        # instead turns the lax.cond into a select that runs BOTH the
        # sparse and the dense pass for every env.
        x_b, scal_b = in_batched
        assert not scal_b, "vmap over radii unsupported; close over them instead"
        if x.ndim == 2 or not x_b:
            return _flocking_sums_sparse_impl(x, scal[0], scal[1], **kw), False
        if x.ndim > 3:
            lead = x.shape[:-2]
            out = _flocking_sums_sparse_impl(
                x.reshape((-1,) + x.shape[-2:]), scal[0], scal[1], **kw
            )
            return out.reshape(lead + out.shape[1:]), True
        return _flocking_sums_sparse_impl(x, scal[0], scal[1], **kw), True

    return f


_SPARSE_VMAPPABLE_CACHE = {}


def _sparse_vmappable_for(k_max, channels):
    key = (k_max, channels)
    if key not in _SPARSE_VMAPPABLE_CACHE:
        _SPARSE_VMAPPABLE_CACHE[key] = _make_sparse_vmappable(*key)
    return _SPARSE_VMAPPABLE_CACHE[key]


@functools.partial(jax.jit, static_argnames=("k_max", "channels"))
def flocking_sums_sparse(
    x: jax.Array,
    comm_radius,
    comm_radius2,
    k_max: int = 16,
    channels: str = "core",
):
    """Block-sparse :func:`ops.pallas_flocking.flocking_sums` (core channels).

    [N, 4] or [B, N, 4] input, N a multiple of 128; returns the same
    [.., N, 16] channel sums as the dense kernel (adjacency-masked sums are
    EXACT — bbox pruning is conservative; float summation order differs).
    O(N * k_max * 128) pairs instead of O(N^2).
    Overflowing the candidate capacity (pathologically clustered swarms)
    falls back to the dense kernel for the whole batch via a REAL
    ``lax.cond`` branch — never wrong, only slower; a ``custom_vmap`` rule
    keeps the predicate scalar under ``jax.vmap`` (vmapping the plain form
    would select-execute both passes).
    """
    scal = jnp.asarray([comm_radius, comm_radius2], jnp.result_type(x.dtype))
    return _sparse_vmappable_for(k_max, channels)(x, scal)


# =============================================================================
# Verlet (skin-expanded) candidate tables: amortize the sort across steps
# =============================================================================


class VerletState(NamedTuple):
    """Reusable cell-list state: the Hilbert permutation + skin-expanded
    candidate table built at ``anchor`` positions.

    Valid (a guaranteed SUPERSET of in-range block pairs) while every agent
    stays within ``skin/2`` of its anchor position; the masked channel sums
    computed through it are exact regardless of how stale the PERMUTATION
    is — a stale curve order only means less-compact blocks, never wrong
    pairs, because the tile kernel masks at ``comm_radius2`` itself.
    """

    perm: jax.Array  # [N] int32 — curve order at build time
    table: jax.Array  # [n_b, k_max] int32 — skin-expanded candidates, -1 pad
    anchor: jax.Array  # [N, 2] — positions at build time
    overflow: jax.Array  # bool — table capacity exceeded at build time


@functools.partial(jax.jit, static_argnames=("k_max",))
def verlet_build(x: jax.Array, comm_radius, skin, k_max: int = 16) -> VerletState:
    """Build a :class:`VerletState` at ``x`` ([N, 4], N a multiple of 128)."""
    perm = hilbert_order(x, comm_radius).astype(jnp.int32)
    xs = x[perm]
    table, overflow = block_pair_table(xs, comm_radius, k_max, skin=skin)
    return VerletState(perm, table, x[:, :2], overflow)


def _flocking_sums_sparse_verlet_impl(
    x: jax.Array,
    vstate: VerletState,
    comm_radius,
    comm_radius2,
    skin,
    channels: str = "core",
):
    """Natively batched Verlet pass: [B, N, 4] (or [N, 4]) positions plus a
    VerletState batched along the same leading axis.

    Mirrors :func:`_flocking_sums_sparse_impl`'s batch discipline: both the
    rebuild predicate and the overflow fallback are batch-wide SCALAR
    ``lax.cond`` branches (one drifted env rebuilds the whole batch — a
    rebuild is always valid, so this is conservative, never wrong), and the
    sparse channel sums run through the shared :func:`_sparse_path_batched`
    as ONE kernel over the batch.
    """
    if channels not in ("core", "expert"):
        # the DENSE kernels' vocabulary is {"core", "full"}; silently
        # treating "full" as core would zero the masked-grad channels
        raise ValueError(
            f"sparse channels must be 'core' or 'expert', got {channels!r}"
        )
    expert = channels == "expert"
    squeeze = x.ndim == 2
    xb = x[None] if squeeze else x
    vb = jax.tree.map(lambda l: l[None], vstate) if squeeze else vstate
    n = xb.shape[1]
    assert n % BLOCK == 0, f"N must be a multiple of {BLOCK} (pad the swarm)"
    k_max = vb.table.shape[-1]

    disp2 = jnp.max(jnp.sum((xb[:, :, :2] - vb.anchor) ** 2, axis=-1))
    stale = disp2 > (0.5 * skin) ** 2
    vb = jax.lax.cond(
        stale,
        lambda _: jax.vmap(
            lambda xi: verlet_build(xi, comm_radius, skin, k_max=k_max)
        )(xb),
        lambda _: vb,
        None,
    )

    def sparse_path(vb_):
        xs = jnp.take_along_axis(xb, vb_.perm[..., None], axis=1)
        return _sparse_path_batched(
            xs, vb_.perm, vb_.table, comm_radius, comm_radius2, expert
        )

    def dense_path(vb_):
        return _dense_path_batched(xb, comm_radius, comm_radius2, expert)

    out = jax.lax.cond(jnp.any(vb.overflow), dense_path, sparse_path, vb)
    if squeeze:
        return out[0], jax.tree.map(lambda l: l[0], vb)
    return out, vb


def _make_verlet_vmappable(channels):
    kw = dict(channels=channels)

    @jax.custom_batching.custom_vmap
    def f(x, vstate, scal):
        return _flocking_sums_sparse_verlet_impl(
            x, vstate, scal[0], scal[1], scal[2], **kw
        )

    @f.def_vmap
    def rule(axis_size, in_batched, x, vstate, scal):
        # route vmap to the NATIVE batch handling (same rationale as
        # _make_sparse_vmappable: keep the rebuild/overflow conds real
        # scalar branches — vmapping the plain form select-executes the
        # dense O(N^2) pass AND a full re-sort every call, per lane)
        x_b, vs_b, scal_b = in_batched
        assert not scal_b, "vmap over radii/skin unsupported; close over them"
        assert all(l == x_b for l in jax.tree.leaves(vs_b)), (
            "x and vstate must be batched together"
        )
        batched = x_b and x.ndim > 2
        if batched and x.ndim > 3:
            lead = x.shape[:-2]
            nd = len(lead)
            flat = lambda l: l.reshape((-1,) + l.shape[nd:])
            out, vs = _flocking_sums_sparse_verlet_impl(
                flat(x), jax.tree.map(flat, vstate),
                scal[0], scal[1], scal[2], **kw,
            )
            out = out.reshape(lead + out.shape[1:])
            vs = jax.tree.map(lambda l: l.reshape(lead + l.shape[1:]), vs)
        else:
            out, vs = _flocking_sums_sparse_verlet_impl(
                x, vstate, scal[0], scal[1], scal[2], **kw
            )
        res = (out, vs)
        return res, jax.tree.map(lambda _: batched, res)

    return f


_VERLET_VMAPPABLE_CACHE = {}


def _verlet_vmappable_for(channels):
    if channels not in _VERLET_VMAPPABLE_CACHE:
        _VERLET_VMAPPABLE_CACHE[channels] = _make_verlet_vmappable(channels)
    return _VERLET_VMAPPABLE_CACHE[channels]


@functools.partial(jax.jit, static_argnames=("channels",))
def flocking_sums_sparse_verlet(
    x: jax.Array,
    vstate: VerletState,
    comm_radius,
    comm_radius2,
    skin,
    channels: str = "core",
):
    """:func:`flocking_sums_sparse` with a cross-call Verlet table.

    Returns ``(sums [.., N, 16], vstate')``.  The Hilbert sort + candidate
    table is REBUILT only when
    some agent has moved more than ``skin/2`` from its anchor — a real
    ``lax.cond`` branch on a scalar predicate, so reuse steps skip the
    sort entirely.  Exactness: the skin-expanded table is a superset of
    the in-range block pairs for any positions within the slack
    (:func:`block_pair_table`), and the tile kernel masks at
    ``comm_radius2``, so only float summation order differs from a
    fresh-built pass.  Table overflow falls back to the dense kernel until
    the next rebuild clears it — never wrong, only slower.

    Accepts [N, 4] (the sequential rollout carry threads the state through
    ``lax.scan`` — ``SparseFlockingEnv.expert_rollout``) or [B, N, 4] with
    a matching batched state.  A ``custom_vmap`` rule routes ``jax.vmap``
    (e.g. ``parallel.batch_expert_rollout``) into the native batched form,
    where rebuild/overflow stay batch-wide scalar branches (one drifted env
    rebuilds all — conservative, never wrong).
    """
    scal = jnp.asarray(
        [comm_radius, comm_radius2, skin], jnp.result_type(x.dtype)
    )
    return _verlet_vmappable_for(channels)(x, vstate, scal)


# =============================================================================
# Sparse GNN aggregation: (A(x) @ H) over listed block pairs only
# =============================================================================


def _sparse_adj_xla(xs, hs, table, comm_radius2):
    """Table-driven (A @ H, degree) over sorted operands: vmap over row
    blocks, scan over the candidate slots with whole contiguous column-block
    loads (``dynamic_slice``)."""
    b, n, _ = xs.shape
    n_b = n // BLOCK

    def one_env(xsi, hsi, tablei):
        xb = xsi.reshape(n_b, BLOCK, 4)

        def one_row(i, row):
            def body(carry, j):
                acc, dacc = carry
                valid = j >= 0
                jc = jnp.maximum(j, 0)
                z = jnp.zeros((), jc.dtype)
                xc = jax.lax.dynamic_slice(xsi, (jc * BLOCK, z), (BLOCK, 4))
                hc = jax.lax.dynamic_slice(
                    hsi, (jc * BLOCK, z), (BLOCK, hsi.shape[-1])
                )
                row_ids = i * BLOCK + jnp.arange(BLOCK)
                col_ids = jc * BLOCK + jnp.arange(BLOCK)
                dx = row[:, 0, None] - xc[None, :, 0]
                dy = row[:, 1, None] - xc[None, :, 1]
                r2 = dx * dx + dy * dy
                adj = (
                    (r2 < comm_radius2)
                    & (row_ids[:, None] != col_ids[None, :])
                ).astype(hsi.dtype)
                t = adj @ hc
                d = jnp.sum(adj, axis=1)
                keep = valid.astype(hsi.dtype)
                return (acc + t * keep, dacc + d * keep), None

            acc0 = (
                jnp.zeros((BLOCK, hsi.shape[-1]), hsi.dtype),
                jnp.zeros((BLOCK,), hsi.dtype),
            )
            (acc, dacc), _ = jax.lax.scan(body, acc0, tablei[i])
            return acc, dacc

        return jax.vmap(one_row)(jnp.arange(n_b), xb)

    out, deg = jax.vmap(one_env)(xs, hs, table)
    return out.reshape(b, n, -1), deg.reshape(b, n)


def _sparse_adj_raw_impl(
    x: jax.Array,
    h: jax.Array,
    scal: jax.Array,
    k_max: int,
):
    """Un-normalized sparse aggregation: ``(A(x) @ H, degree)``.

    No custom_vjp here — differentiation is handled one level up
    (:func:`adjacency_matmul_sparse`'s custom VJP), so this function only
    needs to be vmappable, not differentiable.
    """
    squeeze = x.ndim == 2
    xb = x[None] if squeeze else x
    hb = h[None] if squeeze else h
    n = xb.shape[1]
    assert n % BLOCK == 0, f"N must be a multiple of {BLOCK} (pad the swarm)"
    comm_radius2 = scal[0]
    cr = jnp.sqrt(comm_radius2)

    def prep(xi):
        perm = hilbert_order(xi, cr)
        table, overflow = block_pair_table(xi[perm], cr, k_max)
        return perm, table, overflow

    perm, table, overflow = jax.vmap(prep)(xb)

    def sparse_path(operands):
        perm_, table_ = operands
        take = jax.vmap(lambda v, p: v[p])
        xs = take(xb, perm_)
        hs = take(hb, perm_)
        out_s, deg_s = _sparse_adj_xla(xs, hs, table_, comm_radius2)
        inv = jax.vmap(
            lambda p: jnp.zeros((n,), jnp.int32).at[p].set(jnp.arange(n, dtype=jnp.int32))
        )(perm_)
        # branch contract: out in h.dtype, deg in f32 (the dense fallback's
        # degree is always f32; lax.cond requires identical branch avals)
        return take(out_s, inv).astype(hb.dtype), take(deg_s, inv).astype(jnp.float32)

    def dense_path(operands):
        # pathological clustering: whole-batch dense fallback (see
        # flocking_sums_sparse); raw (A@H, degree) via the dense tile
        from gym_flock_tpu.ops.pallas_flocking import _adj_tile

        out_d, deg_d = _adj_tile(
            xb, xb, hb, jnp.zeros((2,), jnp.int32), comm_radius2
        )
        return out_d.astype(hb.dtype), deg_d.astype(jnp.float32)

    out, deg = jax.lax.cond(
        jnp.any(overflow), dense_path, sparse_path, (perm, table)
    )
    if squeeze:
        return out[0], deg[0]
    return out, deg


def _make_sparse_adj_raw_vmappable(k_max):
    @jax.custom_batching.custom_vmap
    def f(x, h, scal):
        return _sparse_adj_raw_impl(x, h, scal, k_max)

    @f.def_vmap
    def rule(axis_size, in_batched, x, h, scal):
        # same routing as _make_sparse_vmappable: send vmap to the NATIVE
        # [B, N, *] batch form so the overflow fallback stays a real
        # scalar-predicate lax.cond — vmapping the plain form lowers the
        # cond to a select that executes BOTH the sparse and the dense
        # O(N^2) adjacency pass for every element.
        x_b, h_b, scal_b = in_batched
        assert not scal_b, "vmap over radii unsupported; close over them instead"
        if not (x_b or h_b):
            out = _sparse_adj_raw_impl(x, h, scal, k_max)
            return out, (False, False)
        # broadcast a shared (unbatched) operand, like the dense rule
        if not x_b:
            x = jnp.broadcast_to(x[None], (axis_size,) + x.shape)
        if not h_b:
            h = jnp.broadcast_to(h[None], (axis_size,) + h.shape)
        if x.ndim > 3:
            lead = x.shape[:-2]
            out, deg = _sparse_adj_raw_impl(
                x.reshape((-1,) + x.shape[-2:]),
                h.reshape((-1,) + h.shape[-2:]),
                scal, k_max,
            )
            return (
                (out.reshape(lead + out.shape[1:]), deg.reshape(lead + deg.shape[1:])),
                (True, True),
            )
        out, deg = _sparse_adj_raw_impl(x, h, scal, k_max)
        batched = x.ndim == 3
        return (out, deg), (batched, batched)

    return f


_SPARSE_ADJ_RAW_CACHE = {}


def _sparse_adj_raw_for(k_max):
    if k_max not in _SPARSE_ADJ_RAW_CACHE:
        _SPARSE_ADJ_RAW_CACHE[k_max] = _make_sparse_adj_raw_vmappable(k_max)
    return _SPARSE_ADJ_RAW_CACHE[k_max]


def _make_diff_sparse_adj(mean_pool, k_max):
    """Differentiable sparse (A(x) @ H), custom VJP OUTSIDE the custom_vmap
    (grad cannot go through a custom_vmap-wrapped function; same layering
    as ops.pallas_flocking._adj_block).

    The radius adjacency is SYMMETRIC and the bbox candidate relation is
    symmetric (j in table[i] iff i in table[j]), so the backward pass is
    the SAME table-driven pass applied to the cotangent: dH = A d_out
    (mean_pool: dH = A (d_out / deg); deg is H-independent).  Positions
    are a step function of x (zero cotangent a.e.).
    """
    kernel = _sparse_adj_raw_for(k_max)

    @jax.custom_vjp
    def f(x, h, scal):
        out, deg = kernel(x, h, scal)
        if not mean_pool:
            return out
        return out / jnp.where(deg == 0, 1.0, deg)[..., None].astype(out.dtype)

    def fwd(x, h, scal):
        out, deg = kernel(x, h, scal)
        if not mean_pool:
            return out, (x, scal)
        degc = jnp.where(deg == 0, 1.0, deg)[..., None].astype(out.dtype)
        return out / degc, (x, scal, degc)

    def bwd_sum(res, dy):
        x, scal = res
        dh, _ = kernel(x, dy, scal)
        return jnp.zeros_like(x), dh, jnp.zeros_like(scal)

    def bwd_mean(res, dy):
        x, scal, degc = res
        dh, _ = kernel(x, dy / degc, scal)
        return jnp.zeros_like(x), dh, jnp.zeros_like(scal)

    f.defvjp(fwd, bwd_mean if mean_pool else bwd_sum)
    return f


_DIFF_SPARSE_ADJ_CACHE = {}


@functools.partial(jax.jit, static_argnames=("mean_pool", "k_max"))
def adjacency_matmul_sparse(
    x: jax.Array,
    h: jax.Array,
    comm_radius2,
    mean_pool: bool = True,
    k_max: int = 16,
):
    """Block-sparse ``ops.adjacency_matmul``: (A(x) @ H) over the cell-list
    block pairs only — O(N * neighbors) GNN aggregation.

    Same contract as the dense kernel (exact adjacency — bbox pruning is
    conservative; differentiable in ``h`` via a custom VJP that reruns the
    same sparse pass on the cotangent, using the symmetry of both A and
    the candidate relation).  Overflow falls back to the dense kernel
    through a real branch — kept a real branch even under ``jax.vmap``
    via a ``custom_vmap`` rule routing to the native batch form.
    [N, *] or [B, N, *] inputs.
    """
    key = (mean_pool, k_max)
    if key not in _DIFF_SPARSE_ADJ_CACHE:
        _DIFF_SPARSE_ADJ_CACHE[key] = _make_diff_sparse_adj(*key)
    scal = jnp.asarray([comm_radius2], jnp.result_type(x.dtype))
    return _DIFF_SPARSE_ADJ_CACHE[key](x, h, scal)


def khop_aggregate_sparse(
    x: jax.Array,
    features: jax.Array,
    comm_radius2,
    k_hops: int,
    mean_pool: bool = True,
    k_max: int = 16,
):
    """[X, AX, A^2 X, ...] via the block-sparse aggregation — the
    O(N * neighbors) input pipeline for :class:`models.LargeAggregationGNN`
    on cell-list swarms (pass as its ``aggregate_fn``)."""
    zs = [features]
    z = features
    for _ in range(k_hops - 1):
        z = adjacency_matmul_sparse(
            x, z, comm_radius2, mean_pool=mean_pool, k_max=k_max
        )
        zs.append(z)
    return jnp.concatenate(zs, axis=-1)


def _sparse_reset_accept_impl(x: jax.Array, scal: jax.Array, k_max: int):
    """[N, 4] or [B, N, 4] input -> bool / [B] bool (see sparse_reset_accept)."""
    squeeze = x.ndim == 2
    xb = x[None] if squeeze else x
    n = xb.shape[1]
    assert n % BLOCK == 0, f"N must be a multiple of {BLOCK} (pad the swarm)"
    n_b = n // BLOCK
    comm_radius, comm_radius2, min_dist_thresh = scal[0], scal[1], scal[2]
    prune_r = jnp.maximum(comm_radius, min_dist_thresh)

    def prep(xi):
        perm = hilbert_order(xi, comm_radius)
        xs = xi[perm]
        table, overflow = block_pair_table(xs, prune_r, k_max)
        return xs, table, overflow

    xs, table, overflow = jax.vmap(prep)(xb)

    def sparse_ok(operands):
        xs_b, table_b = operands

        def one_env(xs_, table_):
            xblocks = xs_.reshape(n_b, BLOCK, 4)

            def one_row(i, row):
                def body(carry, j):
                    min_r2, deg = carry
                    valid = j >= 0
                    jc = jnp.maximum(j, 0)
                    xc = jax.lax.dynamic_slice(
                        xs_, (jc * BLOCK, jnp.zeros((), jc.dtype)), (BLOCK, 4)
                    )
                    row_ids = i * BLOCK + jnp.arange(BLOCK)
                    col_ids = jc * BLOCK + jnp.arange(BLOCK)
                    dx = row[:, 0, None] - xc[None, :, 0]
                    dy = row[:, 1, None] - xc[None, :, 1]
                    r2 = dx * dx + dy * dy
                    r2 = jnp.where(
                        row_ids[:, None] == col_ids[None, :], jnp.inf, r2
                    )
                    t_min = jnp.min(r2, axis=1)
                    t_deg = jnp.sum((r2 < comm_radius2).astype(jnp.int32), axis=1)
                    min_r2 = jnp.where(valid, jnp.minimum(min_r2, t_min), min_r2)
                    deg = deg + jnp.where(valid, t_deg, 0).astype(deg.dtype)
                    return (min_r2, deg), None

                init = (
                    jnp.full((BLOCK,), jnp.inf, xs_.dtype),
                    jnp.zeros((BLOCK,), jnp.int32),
                )
                (min_r2, deg), _ = jax.lax.scan(body, init, table_[i])
                return min_r2, deg

            min_r2, deg = jax.vmap(one_row)(jnp.arange(n_b), xblocks)
            return (jnp.min(deg) >= 2) & (
                jnp.sqrt(jnp.min(min_r2)) > min_dist_thresh
            )

        return jax.vmap(one_env)(xs_b, table_b)

    def dense_ok(operands):
        xs_b, _ = operands

        def one_env(xs_):
            px, py = xs_[:, 0], xs_[:, 1]
            dx = px[:, None] - px[None, :]
            dy = py[:, None] - py[None, :]
            r2 = dx * dx + dy * dy
            eye = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0) == (
                jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
            )
            r2 = jnp.where(eye, jnp.inf, r2)
            degree = jnp.min(jnp.sum(r2 < comm_radius2, axis=1))
            return (degree >= 2) & (jnp.sqrt(jnp.min(r2)) > min_dist_thresh)

        return jax.vmap(one_env)(xs_b)

    out = jax.lax.cond(jnp.any(overflow), dense_ok, sparse_ok, (xs, table))
    return out[0] if squeeze else out


def _make_reset_accept_vmappable(k_max):
    @jax.custom_batching.custom_vmap
    def f(x, scal):
        return _sparse_reset_accept_impl(x, scal, k_max)

    @f.def_vmap
    def rule(axis_size, in_batched, x, scal):
        # keep the overflow fallback a real scalar branch under vmap (the
        # batched reset path: batch_rollout / batch_expert_rollout vmap
        # reset_env) — a vmapped plain cond would select-execute the dense
        # O(N^2) test for every env, the exact cost this function avoids
        x_b, scal_b = in_batched
        assert not scal_b, "vmap over thresholds unsupported; close over them"
        if x.ndim == 2 or not x_b:
            return _sparse_reset_accept_impl(x, scal, k_max), False
        if x.ndim > 3:
            lead = x.shape[:-2]
            out = _sparse_reset_accept_impl(
                x.reshape((-1,) + x.shape[-2:]), scal, k_max
            )
            return out.reshape(lead), True
        return _sparse_reset_accept_impl(x, scal, k_max), True

    return f


_RESET_ACCEPT_CACHE = {}


@functools.partial(jax.jit, static_argnames=("k_max",))
def sparse_reset_accept(
    x: jax.Array,
    comm_radius,
    comm_radius2,
    min_dist_thresh,
    k_max: int = 16,
):
    """Rejection-sampling acceptance test (min degree >= 2 AND min pairwise
    distance > ``min_dist_thresh``, reference flocking_relative.py:164) in
    O(N * k_max * BLOCK) memory instead of the dense O(N^2) pass.

    Exactness: the candidate table is built at pruning radius
    ``max(comm_radius, min_dist_thresh)``, so every pair that could either
    contribute degree or violate the distance threshold is in a listed
    block — pruned pairs are provably farther than both cutoffs.  Overflow
    (pathologically clustered draws) falls back to a dense test via a real
    ``lax.cond`` branch, kept a real branch under ``jax.vmap`` by a
    ``custom_vmap`` rule routing to the native [B, N, 4] batch form.
    [N, 4] or [B, N, 4] input, N a multiple of BLOCK.
    """
    if k_max not in _RESET_ACCEPT_CACHE:
        _RESET_ACCEPT_CACHE[k_max] = _make_reset_accept_vmappable(k_max)
    scal = jnp.asarray(
        [comm_radius, comm_radius2, min_dist_thresh], jnp.result_type(x.dtype)
    )
    return _RESET_ACCEPT_CACHE[k_max](x, scal)
