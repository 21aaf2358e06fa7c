"""Large-N flocking pairwise interactions without [N, N] arrays in memory.

The dense path (``gym_flock_tpu.envs.flocking``) materializes [N, N] channel
arrays; at swarm sizes N >~ 1k with large env batches those intermediates
(and, for GNN aggregation, the adjacency itself — 1 GB at N=16k) would live
in device memory.  This module keeps the pair domain out of it:

* :func:`flocking_sums` — every per-agent neighbor reduction of the flocking
  family in one pass: the 6 observation feature sums of ``compute_helpers``
  (reference flocking_relative.py:124-128), the Turner potential-gradient
  sums of ``controller`` (:204-226), and the neighbor degree.  Plain XLA:
  every [.., N, N] intermediate is an elementwise producer of one
  multi-output row reduction, which XLA fuses into a single traversal of
  the pair domain, so memory traffic is O(N).
* :func:`adjacency_matmul` — (A(x) @ H) with the radius-graph adjacency.  On
  the GPU a Pallas kernel (Triton route) builds each [BI, BJ] adjacency tile
  in registers from positions and feeds it to the tensor cores, so A never
  exists in device memory; other backends run the plain XLA product.
  :func:`khop_aggregate` builds the AggregationGNN input pipeline
  [X, AX, A^2 X, ...] on top.

Channel layout of the [N, 16] outputs (padding zeros):
  0: sum adj*dvx        1: sum adj*dx/r^4   2: sum adj*dx/r^2
  3: sum adj*dvy        4: sum adj*dy/r^4   5: sum adj*dy/r^2
  6: sum grad_x         7: sum grad_y       8: degree (sum adj)
  -- channels below only with ``channels="full"`` (zeros in the "core" set
     that ``flocking_sums`` computes) --
  9: min r^2 (combine across blocks with ``min``; the sharded reset's
     min-distance acceptance test, reference flocking_relative.py:164)
  10: sum adj*grad_x    11: sum adj*grad_y  (decentralized expert's
     adjacency-masked gradient sums, reference flocking_relative.py:201-207)

:func:`flocking_sums_block` is the cross-block form — row agents against a
*different* column block, with global-index offsets for the diagonal mask —
the per-ring-step tile of the agent-axis-sharded passes
(``parallel.agent_shard``); :func:`flocking_sums` is the symmetric case.

adj = r^2 < comm_radius^2 off-diagonal; grad uses the reference's quirky
cutoff r^2 > comm_radius (NOT squared; flocking_relative.py:225).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = [
    "flocking_sums",
    "flocking_sums_block",
    "adjacency_matmul_block",
    "turner_controller_large",
    "flocking_features_large",
    "flocking_sums_batched",
    "adjacency_matmul",
    "khop_aggregate",
]

N_OUT = 16
_PAD_POS = 1.0e15  # padding agents parked far away: no adjacency


def _round_up(x, m):
    return ((x + m - 1) // m) * m


# =============================================================================
# flocking_sums
# =============================================================================


def _flocking_sums_xla(
    xr: jax.Array, xc: jax.Array, row_offset, col_offset, comm_radius,
    comm_radius2, channels: str = "core",
):
    """Channel sums (module docstring layout) of row agents ``xr`` [.., m, 4]
    against column agents ``xc`` [.., k, 4]; leading batch dims broadcast.

    ``row_offset``/``col_offset`` are the blocks' global agent indices: the
    self-pair mask is a global-id equality test, so tiling [row block] x
    [all column blocks] and combining reproduces the full-swarm sums.  The
    mask is an iota equality, NOT ``jnp.eye``, which would materialize an
    [m, k] operand and break the reduce fusion."""
    dtype = xr.dtype
    m, k = xr.shape[-2], xc.shape[-2]
    dx = xr[..., :, None, 0] - xc[..., None, :, 0]
    dy = xr[..., :, None, 1] - xc[..., None, :, 1]
    dvx = xr[..., :, None, 2] - xc[..., None, :, 2]
    dvy = xr[..., :, None, 3] - xc[..., None, :, 3]
    r2 = dx * dx + dy * dy
    row = row_offset + jax.lax.broadcasted_iota(jnp.int32, (m, k), 0)
    col = col_offset + jax.lax.broadcasted_iota(jnp.int32, (m, k), 1)
    r2 = jnp.where(row == col, jnp.inf, r2)
    adj = (r2 < comm_radius2).astype(dtype)
    inv = 1.0 / r2
    inv2 = inv * inv
    gfac = jnp.where(r2 > comm_radius, 0.0, 2.0 * inv * (1.0 - inv))
    chans = [
        jnp.sum(dvx * adj, axis=-1),
        jnp.sum(dx * inv2 * adj, axis=-1),
        jnp.sum(dx * inv * adj, axis=-1),
        jnp.sum(dvy * adj, axis=-1),
        jnp.sum(dy * inv2 * adj, axis=-1),
        jnp.sum(dy * inv * adj, axis=-1),
        jnp.sum(dx * gfac, axis=-1),
        jnp.sum(dy * gfac, axis=-1),
        jnp.sum(adj, axis=-1),
    ]
    if channels == "full":
        chans += [
            jnp.min(r2, axis=-1),
            jnp.sum(dx * gfac * adj, axis=-1),
            jnp.sum(dy * gfac * adj, axis=-1),
        ]
    elif channels != "core":
        raise ValueError(f"channels must be 'core' or 'full', got {channels!r}")
    out = jnp.stack(chans, axis=-1)
    pad = jnp.zeros(out.shape[:-1] + (N_OUT - len(chans),), dtype)
    return jnp.concatenate([out, pad], axis=-1)


@jax.jit
def flocking_sums(x: jax.Array, comm_radius, comm_radius2):
    """All per-agent pairwise reductions for flocking, one fused pass.

    x: [N, 4] or [.., N, 4] agent states; returns [.., N, 16] channel sums
    (core channel set, layout above).  ``jax.vmap`` is native."""
    return _flocking_sums_xla(x, x, 0, 0, comm_radius, comm_radius2)


def flocking_features_large(x: jax.Array, comm_radius, comm_radius2):
    """Large-N replacement for ``flocking_features``: returns
    ``(state_values [N,6], degree [N])`` without materializing [N,N] arrays.
    (The dense adjacency itself is deliberately not produced at this scale;
    consumers should aggregate through :func:`adjacency_matmul` instead.)"""
    s = flocking_sums(x, comm_radius, comm_radius2)
    return s[:, 0:6], s[:, 8]


def turner_controller_large(
    x: jax.Array,
    comm_radius,
    comm_radius2,
    action_scalar,
    centralized: bool = True,
):
    """Turner expert via the fused pass (large-N path).

    Centralized: the closed form sum_j (v_i - v_j) = N v_i - sum_j v_j for
    the velocity-consensus term plus the cutoff-masked gradient sums.
    Decentralized (reference flocking_relative.py:201-207): both terms
    additionally masked by the adjacency — channels 0/3 and 10/11.
    """
    n = x.shape[0]
    if centralized:
        s = flocking_sums(x, comm_radius, comm_radius2)
        s_gx, s_gy = s[:, 6], s[:, 7]
        s_dvx = n * x[:, 2] - jnp.sum(x[:, 2])
        s_dvy = n * x[:, 3] - jnp.sum(x[:, 3])
    else:
        s = flocking_sums_block(x, x, 0, 0, comm_radius, comm_radius2)
        s_gx, s_gy = s[:, 10], s[:, 11]
        s_dvx, s_dvy = s[:, 0], s[:, 3]
    controls = jnp.stack((-s_gx - s_dvx, -s_dvy - s_gy), axis=1)
    return jnp.clip(controls, -10.0, 10.0) / action_scalar


def flocking_sums_block(
    xr: jax.Array,
    xc: jax.Array,
    row_offset,
    col_offset,
    comm_radius,
    comm_radius2,
    channels: str = "full",
):
    """Cross-block flocking reductions: row agents ``xr`` [m, 4] (or [.., m, 4])
    against a column block ``xc`` [k, 4], returning [m, 16] channel sums
    (layout in the module docstring; channel 9 combines across blocks with
    ``min``, all others with ``+``).  ``channels="core"`` computes only the
    pure-sum channels 0..8 (9..11 read as zeros), ``"full"`` adds min-r2
    and the adjacency-masked gradient sums.

    ``row_offset``/``col_offset`` are the blocks' global agent indices, so
    tiling [row block] x [all column blocks] and combining reproduces the
    full-swarm reductions exactly.  This is the tile of the agent-sharded
    ring schedule (``parallel.agent_shard.flocking_sums_sharded``).
    """
    return _flocking_sums_xla(
        xr, xc, row_offset, col_offset, comm_radius, comm_radius2, channels
    )


def flocking_sums_batched(xs: jax.Array, comm_radius, comm_radius2):
    """Batched :func:`flocking_sums` ([B, N, 4] input).  Kept as an explicit
    name; identical to calling ``flocking_sums`` with a batched input."""
    return flocking_sums(xs, comm_radius, comm_radius2)


# =============================================================================
# adjacency_matmul: (A(x) @ H) with A generated tile by tile
# =============================================================================

_BI = 64  # row agents per kernel program
_BJ = 64  # column agents per loop step


def _adj_matmul_xla(xr, xc, h, offs, comm_radius2):
    """Plain (A(xr, xc) @ H, degree): the adjacency is materialized.  The
    reference the kernel is checked against, and the path on every backend
    but the GPU.  ``precision=HIGHEST`` keeps the product float32-exact
    (A is 0/1), as the kernel is."""
    m, k = xr.shape[-2], xc.shape[-2]
    dx = xr[..., :, None, 0] - xc[..., None, :, 0]
    dy = xr[..., :, None, 1] - xc[..., None, :, 1]
    row = offs[0] + jax.lax.broadcasted_iota(jnp.int32, (m, k), 0)
    col = offs[1] + jax.lax.broadcasted_iota(jnp.int32, (m, k), 1)
    adj = ((dx * dx + dy * dy < comm_radius2) & (row != col)).astype(jnp.float32)
    out = jnp.matmul(
        adj, h.astype(jnp.float32), precision=jax.lax.Precision.HIGHEST
    )
    return out.astype(h.dtype), jnp.sum(adj, axis=-1)


def _adj_matmul_kernel(offs_ref, cr2_ref, rx_ref, ry_ref, cx_ref, cy_ref, h_ref,
                       out_ref, deg_ref, *, bj):
    # one program per (env, row block); the loop over column blocks keeps
    # the accumulator in registers
    bi = rx_ref.shape[0]
    k_pad = h_ref.shape[0]
    cr2 = cr2_ref[0]
    rx, ry = rx_ref[...], ry_ref[...]
    rid = offs_ref[0] + pl.program_id(1) * bi + jnp.arange(bi, dtype=jnp.int32)

    def body(j, carry):
        acc, deg = carry
        cols = pl.ds(j * bj, bj)
        dx = rx[:, None] - cx_ref[cols][None, :]
        dy = ry[:, None] - cy_ref[cols][None, :]
        cid = offs_ref[1] + j * bj + jnp.arange(bj, dtype=jnp.int32)
        adj = (dx * dx + dy * dy < cr2) & (rid[:, None] != cid[None, :])
        a = adj.astype(jnp.bfloat16)  # 0/1: exact in bf16
        # H as the sum of three bf16 parts (8 significant bits each): the
        # bf16 tensor-core products then carry float32's 24 bits
        rest = h_ref[cols, :]
        for _ in range(3):
            part = rest.astype(jnp.bfloat16)
            acc = acc + pl.dot(a, part)
            rest = rest - part.astype(jnp.float32)
        return acc, deg + jnp.sum(adj.astype(jnp.float32), axis=1)

    init = (jnp.zeros(out_ref.shape, jnp.float32), jnp.zeros((bi,), jnp.float32))
    acc, deg = jax.lax.fori_loop(0, k_pad // bj, body, init)
    out_ref[...] = acc
    deg_ref[...] = deg


def _pad_coords(x, n_pad, salt=0.0):
    """[B, n, >=2] -> px, py [B, n_pad]: pads parked on a far-away ladder.
    ``salt`` (a fraction of a rung) displaces one side's ladder so that row
    pads and column pads never coincide."""
    b, n, _ = x.shape
    ppos = _PAD_POS * (1.0 + salt + jnp.arange(n_pad - n, dtype=x.dtype))
    ppos = jnp.broadcast_to(ppos, (b, n_pad - n))
    return (
        jnp.concatenate([x[:, :, 0], ppos], axis=1),
        jnp.concatenate([x[:, :, 1], -ppos], axis=1),
    )


def _vma(*arrays):
    """``{"vma": axes}`` for kernel outputs under ``shard_map``: the axes
    the inputs vary over (empty outside ``shard_map``)."""
    vma = frozenset().union(
        *(getattr(jax.typeof(v), "vma", frozenset()) for v in arrays)
    )
    return {"vma": vma} if vma else {}


def _adj_matmul_triton(xr, xc, h, offs, comm_radius2, interpret=False):
    """Kernel (A(xr, xc) @ H, degree) through Pallas' Triton route.

    ``xr`` [.., m, >=2] row positions, ``xc`` [.., k, >=2] / ``h`` [.., k, F]
    the column block, ``offs`` the blocks' global index offsets [2] int32.
    Rows pad to ``_BI``, columns to ``_BJ`` and features to a power of two
    >= 16 (the tensor-core minimum); everything pads with zero weight."""
    bi, bj = _BI, _BJ
    lead = xr.shape[:-2]
    m, k, f = xr.shape[-2], xc.shape[-2], h.shape[-1]
    xr = xr.reshape((-1, m, xr.shape[-1]))
    xc = xc.reshape((-1, k, xc.shape[-1]))
    hf = h.reshape((-1, k, f)).astype(jnp.float32)
    b = xr.shape[0]
    m_pad, k_pad = _round_up(m, bi), _round_up(k, bj)
    fp = max(16, pl.next_power_of_2(f))
    rx, ry = _pad_coords(xr, m_pad)
    cx, cy = _pad_coords(xc, k_pad, salt=0.5)
    hp = jnp.pad(hf, ((0, 0), (0, k_pad - k), (0, fp - f)))
    cr2 = jnp.reshape(jnp.asarray(comm_radius2, jnp.float32), (1,))

    kw = _vma(xr, xc, h)
    row = pl.BlockSpec((None, bi), lambda e, i: (e, i))
    col = pl.BlockSpec((None, k_pad), lambda e, i: (e, 0))
    scalar = lambda n: pl.BlockSpec((n,), lambda e, i: (0,))
    out, deg = pl.pallas_call(
        functools.partial(_adj_matmul_kernel, bj=bj),
        grid=(b, m_pad // bi),
        in_specs=[
            scalar(2), scalar(1), row, row, col, col,
            pl.BlockSpec((None, k_pad, fp), lambda e, i: (e, 0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((None, bi, fp), lambda e, i: (e, i, 0)),
            row,
        ],
        out_shape=[
            jax.ShapeDtypeStruct((b, m_pad, fp), jnp.float32, **kw),
            jax.ShapeDtypeStruct((b, m_pad), jnp.float32, **kw),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="adjacency_matmul",
    )(offs.astype(jnp.int32), cr2, rx, ry, cx, cy, hp)
    out = out[:, :m, :f].astype(h.dtype).reshape(lead + (m, f))
    return out, deg[:, :m].reshape(lead + (m,))


def _adj_tile(xr, xc, h, offs, comm_radius2):
    """Kernel on the GPU, plain XLA product elsewhere."""
    if jax.default_backend() == "gpu":
        return _adj_matmul_triton(xr, xc, h, offs, comm_radius2)
    return _adj_matmul_xla(xr, xc, h, offs, comm_radius2)


@jax.custom_vjp
def _adj_block(xr, xc, h, offs, comm_radius2):
    return _adj_tile(xr, xc, h, offs, comm_radius2)


def _adj_block_fwd(xr, xc, h, offs, comm_radius2):
    return _adj_tile(xr, xc, h, offs, comm_radius2), (xr, xc, offs, comm_radius2)


def _adj_block_bwd(res, cts):
    """The cross-block adjacency A(xr, xc) transposed is the swapped-operand
    block A(xc, xr) (the global-id mask commutes), so dH = A(xc, xr) @ dout:
    one more run of the same tile.  deg does not depend on H; positions are
    a step function of x (zero cotangent a.e., as autodiff of a dense
    ``(r2 < cr2)`` adjacency gives); the int offsets get float0."""
    xr, xc, offs, comm_radius2 = res
    d_out, _ = cts
    dh, _ = _adj_tile(xc, xr, d_out, offs[::-1], comm_radius2)
    return (
        jnp.zeros_like(xr),
        jnp.zeros_like(xc),
        dh,
        np.zeros(offs.shape, jax.dtypes.float0),
        jnp.zeros_like(comm_radius2),
    )


_adj_block.defvjp(_adj_block_fwd, _adj_block_bwd)


def _cr2_array(comm_radius2, x):
    return jnp.asarray(comm_radius2, jnp.result_type(x.dtype))


def adjacency_matmul_block(
    xr: jax.Array,
    xc: jax.Array,
    h: jax.Array,
    row_offset,
    col_offset,
    comm_radius2,
):
    """Partial GNN aggregation tile for the agent-sharded ring schedule:
    ``(A(xr, xc) @ H_block, degree)``.  Combine partials by summing both
    outputs across column blocks, then mean-pool normalize — see
    ``parallel.agent_shard.adjacency_matmul_sharded``.  Differentiable in
    ``h`` via a custom VJP (the transposed tile is the swapped-operand
    block), so the sharded GNN aggregation trains."""
    offs = jnp.stack([jnp.asarray(row_offset), jnp.asarray(col_offset)]).astype(
        jnp.int32
    )
    return _adj_block(xr, xc, h, offs, _cr2_array(comm_radius2, xr))


@functools.partial(jax.jit, static_argnames=("mean_pool",))
def adjacency_matmul(
    x: jax.Array,
    h: jax.Array,
    comm_radius2,
    mean_pool: bool = True,
):
    """(A(x) @ H) for the radius-graph adjacency of swarm ``x``.

    The GNN aggregation primitive for large swarms.  On the GPU each
    adjacency tile is built from positions in registers and fed to the
    tensor cores — A never exists in device memory, and the footprint is
    O(N*F) where a dense A is 1 GB per env at N=16k.  With ``mean_pool``
    rows are degree-normalized exactly like ``mean_pool_normalize``
    (reference flocking_relative.py:120-122).

    Accepts [N, *] or batched [.., N, *] inputs; ``jax.vmap`` works.
    DIFFERENTIABLE in ``h`` via a custom VJP (one extra pass; positions get
    the a.e.-correct zero cotangent) — large-swarm GNNs train through it
    (``models.LargeAggregationGNN``).
    """
    out, deg = _adj_block(
        x, x, h, jnp.zeros((2,), jnp.int32), _cr2_array(comm_radius2, x)
    )
    if not mean_pool:
        return out
    return out / jnp.where(deg == 0, 1.0, deg)[..., None].astype(out.dtype)


def khop_aggregate(
    x: jax.Array,
    features: jax.Array,
    comm_radius2,
    k_hops: int,
    mean_pool: bool = True,
):
    """[X, AX, A^2 X, ...] concatenated — the AggregationGNN input pipeline
    for large N, built on :func:`adjacency_matmul` (A is never materialized).
    """
    zs = [features]
    z = features
    for _ in range(k_hops - 1):
        z = adjacency_matmul(x, z, comm_radius2, mean_pool=mean_pool)
        zs.append(z)
    return jnp.concatenate(zs, axis=-1)
