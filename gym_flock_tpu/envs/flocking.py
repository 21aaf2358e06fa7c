"""Flocking environment family — pure-JAX double-integrator swarms.

Batched, jit-compiled re-design of the reference flocking envs:

* ``FlockingRelativeEnv``  — reference flocking/flocking_relative.py:18-305
* ``FlockingAbsoluteEnv``  — reference flocking/flocking.py:5-25 (``Flocking-v0``)
* ``FlockingLeaderEnv``    — reference flocking/flocking_leader.py:5-57
* ``FlockingObstacleEnv``  — reference flocking/flocking_obstacle.py:13-118
* ``FlockingStochasticEnv``— reference flocking/flocking_stoch.py:5-45
* ``FlockingTwoFlocksEnv`` — reference flocking/flocking_twoflocks.py:6-26

Semantics (dynamics, features, rewards, expert controller, and the
reference's numerical quirks — see notes inline) are preserved; the
implementation is a fresh design: state is an immutable pytree, every method
is a pure function of ``(key, state, action, params)``, all shapes static, so
``jit(vmap(step))`` steps thousands of swarms in lockstep on one chip and
``shard_map`` spreads the batch across a mesh (``gym_flock_tpu.parallel``).

The O(N^2) ``compute_helpers`` pairwise kernel (reference
flocking_relative.py:111-134) — >90% of reference step time — is expressed as
dense masked tensor ops that XLA fuses into a single pass; a blockwise Pallas
variant for very large N lives in ``gym_flock_tpu.ops.pallas_pairwise``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
from gym_flock_tpu.core import struct

from gym_flock_tpu.core.env import Env, EnvState
from gym_flock_tpu.core.spaces import Box
from gym_flock_tpu.ops.pairwise import mean_pool_normalize, radius_adjacency

__all__ = [
    "FlockingParams",
    "FlockingState",
    "FlockingRelativeEnv",
    "FlockingAbsoluteEnv",
    "FlockingLeaderEnv",
    "FlockingObstacleEnv",
    "FlockingStochasticEnv",
    "FlockingTwoFlocksEnv",
    "LargeFlockingEnv",
    "SparseFlockingEnv",
    "flocking_features",
    "flocking_obs_expert_pass",
    "turner_controller",
]


# =============================================================================
# Params / State
# =============================================================================


@struct.dataclass
class FlockingParams:
    """Parameters of the flocking family.

    Defaults mirror reference flocking_relative.py:27-64.  Fields marked
    static participate in trace-time shapes/branches.
    """

    # --- static (shape- or branch-determining) ---
    n_agents: int = struct.field(pytree_node=False, default=100)
    max_steps: int = struct.field(pytree_node=False, default=1000)
    mean_pooling: bool = struct.field(pytree_node=False, default=True)
    centralized: bool = struct.field(pytree_node=False, default=True)
    # rejection-sampling reset: bounded trip count (reference uses an
    # unbounded while loop, flocking_relative.py:164)
    max_reset_tries: int = struct.field(pytree_node=False, default=64)
    # reference params_from_cfg scales r_max by sqrt(n) (flocking_relative.py:75);
    # without it the default reset never accepts (SURVEY.md §5.9b).
    auto_scale_r_max: bool = struct.field(pytree_node=False, default=True)
    # variant statics
    n_leaders: int = struct.field(pytree_node=False, default=2)
    n_obstacles: int = struct.field(pytree_node=False, default=4)
    n_neighbors: int = struct.field(pytree_node=False, default=7)  # absolute-obs k
    # SparseFlockingEnv rollouts: Verlet slack distance (the Hilbert sort +
    # candidate table rebuild only when an agent moved > skin/2 since the
    # last build — ops.sparse_flocking.flocking_sums_sparse_verlet).  None
    # resolves to the dynamic comm_radius; <= 0 disables reuse (rebuild
    # every step).  Static: only this field (never the resolved value)
    # gates the Python-level branch, so params may be a traced argument.
    verlet_skin: float | None = struct.field(pytree_node=False, default=None)
    # bit-exact parity mode: obs/expert/reward mirror the reference's
    # NumPy primitive sequence exactly (0-ULP at x64; see
    # flocking_features_exact).  Correctness mode, not the perf path.
    parity_exact: bool = struct.field(pytree_node=False, default=False)

    # --- dynamic ---
    comm_radius: float = 0.9
    dt: float = 0.01
    v_max: float = 5.0
    r_max: float = 1.0
    action_scalar: float = 10.0
    max_accel: float = 1.0
    min_dist_thresh: float = 0.1
    # stochastic-dt variant (reference flocking_stoch.py:9-12)
    dt_mean: float = 0.12
    dt_sigma: float = 0.018
    stoch_scale: float = 6.0
    stoch_max_accel: float = 0.5

    @property
    def comm_radius2(self) -> float:
        return self.comm_radius * self.comm_radius

    @property
    def v_bias(self) -> float:
        return self.v_max

    @property
    def r_max_eff(self) -> float:
        import numpy as _np

        return self.r_max * float(_np.sqrt(self.n_agents)) if self.auto_scale_r_max else self.r_max


@struct.dataclass
class FlockingState(EnvState):
    """x: [N, 4] rows (px, py, vx, vy); mean/init vel cached as in reference."""

    x: jax.Array
    mean_vel: jax.Array  # [2]
    init_vel: jax.Array  # [N, 2]


# =============================================================================
# Kernels
# =============================================================================


def _pairwise_channels(x: jax.Array, obstacle_mask: jax.Array | None = None,
                       exact: bool = False):
    """Channel-separated pairwise diffs: (dx, dy, dvx, dvy, r2), each [N, N].

    Layout note: the reference materializes one [N, N, 4] ``diff`` tensor
    (flocking_relative.py:113).  Keeping each channel as its own [N, N]
    array (structure-of-arrays) avoids a minor dimension of 4 and lets XLA
    fuse the whole feature/expert chain into the reductions.
    """
    px, py, vx, vy = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    dx = px[:, None] - px[None, :]
    dy = py[:, None] - py[None, :]
    dvx = vx[:, None] - vx[None, :]
    dvy = vy[:, None] - vy[None, :]
    if obstacle_mask is not None:
        # broken agents don't contribute to velocity differences
        # (reference flocking_obstacle.py:80-81 zeroes rows AND columns)
        keep = ~obstacle_mask
        vel_keep = keep[:, None] & keep[None, :]
        dvx = jnp.where(vel_keep, dvx, 0.0)
        dvy = jnp.where(vel_keep, dvy, 0.0)
    n = x.shape[0]
    if exact:
        # parity mode: block fma contraction of the sum of products
        # (reference flocking_relative.py:114 rounds each multiply)
        r2 = _rnd(dx * dx) + _rnd(dy * dy)
    else:
        r2 = dx * dx + dy * dy
    # diagonal mask as an iota equality, not jnp.eye: the eye constant is a
    # materialized [N, N] operand that blocks full reduce fusion (measured
    # 16% slower at N=16k; bit-identical semantics)
    eye = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0) == jax.lax.broadcasted_iota(
        jnp.int32, (n, n), 1
    )
    r2 = jnp.where(eye, jnp.inf, r2)
    return dx, dy, dvx, dvy, r2


def flocking_features(
    x: jax.Array,
    comm_radius2,
    obstacle_mask: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """The ``compute_helpers`` kernel (reference flocking_relative.py:111-134).

    Returns ``(state_values [N,6], adj [N,N], adj_mean [N,N], r2 [N,N])``.

    Feature channels per neighbor pair, summed over neighbors j with
    ``r2 < comm_radius^2``:
        0: dvx   1: dx/r^4   2: dx/r^2   3: dvy   4: dy/r^4   5: dy/r^2

    ``obstacle_mask`` (bool [N], True = obstacle) zeroes velocity-difference
    rows/cols before feature assembly, matching FlockingObstacleEnv
    (reference flocking_obstacle.py:80-81).
    """
    dx, dy, dvx, dvy, r2 = _pairwise_channels(x, obstacle_mask)
    adj = radius_adjacency(r2, comm_radius2)
    adj_mean = mean_pool_normalize(adj)

    inv = 1.0 / r2
    inv2 = inv * inv
    # masked neighbor sums; off-diagonal r2 finite, diagonal Inf -> features 0
    state_values = jnp.stack(
        (
            jnp.sum(dvx * adj, axis=1),
            jnp.sum(dx * inv2 * adj, axis=1),
            jnp.sum(dx * inv * adj, axis=1),
            jnp.sum(dvy * adj, axis=1),
            jnp.sum(dy * inv2 * adj, axis=1),
            jnp.sum(dy * inv * adj, axis=1),
        ),
        axis=1,
    )  # [N, 6]
    return state_values, adj, adj_mean, r2


def turner_potential_grad(pos_diff_c: jax.Array, r2: jax.Array, comm_radius) -> jax.Array:
    """Gradient of the Turner-2003 flocking potential (reference :214-226).

    NOTE the reference quirk kept for parity: the cutoff compares ``r2``
    (distance *squared*) against ``comm_radius`` (NOT squared) —
    flocking_relative.py:225.

    Perf: expressed through ``inv = 1/r2`` so that the products
    ``pos_diff*inv`` / ``pos_diff*inv^2`` are common subexpressions with
    :func:`flocking_features` — in the fused expert+step program this cuts
    the [N,N] division count from 5 to 1 (divides are the dearest
    elementwise operation of the pass; the reference formulation spends 2
    divides per channel, flocking_relative.py:223).
    """
    inv = 1.0 / r2
    inv2 = inv * inv
    grad = -2.0 * (pos_diff_c * inv2) + 2.0 * (pos_diff_c * inv)
    return jnp.where(r2 > comm_radius, 0.0, grad)


def turner_controller(
    x: jax.Array,
    params: FlockingParams,
    centralized: bool | None = None,
    obstacle_mask: jax.Array | None = None,
) -> jax.Array:
    """Turner-2003 potential-field expert (reference flocking_relative.py:194-212).

    control_x = -(sum_j grad_x + sum_j dvx); clip to [-10, 10]; / action_scalar.
    Decentralized mode masks contributions by the adjacency matrix.
    """
    if centralized is None:
        centralized = params.centralized
    dx, dy, dvx, dvy, r2 = _pairwise_channels(x, obstacle_mask)
    gx = turner_potential_grad(dx, r2, params.comm_radius)
    gy = turner_potential_grad(dy, r2, params.comm_radius)

    if not centralized:
        adj = radius_adjacency(r2, params.comm_radius2)
        dvx = dvx * adj
        dvy = dvy * adj
        gx = gx * adj
        gy = gy * adj

    s_dvx = jnp.sum(dvx, axis=1)
    s_dvy = jnp.sum(dvy, axis=1)
    s_gx = jnp.sum(gx, axis=1)
    s_gy = jnp.sum(gy, axis=1)

    controls = jnp.stack((-s_gx - s_dvx, -s_dvy - s_gy), axis=1)
    controls = jnp.clip(controls, -10.0, 10.0)
    return controls / params.action_scalar


# =============================================================================
# Bit-exact parity mode (reference op order; VERDICT r4 next #5)
# =============================================================================
#
# The SoA kernels above legitimately reorder float arithmetic (shared
# reciprocals, XLA reduce trees) — 1e-9-level differences at f64.  The
# functions below instead mirror the reference's NumPy primitive sequence
# EXACTLY, so that under x64 the whole trajectory (state, obs, network,
# reward, expert action) is 0-ULP equal to the reference
# (flocking_relative.py:91-226).  Two facts pin the required reduction
# orders (verified empirically in test_flocking_parity, numpy 2.x):
#   * np.sum over a NON-contiguous axis (axis=1 of C-contiguous [N,N,C],
#     axis=0 of [N,C]) accumulates SEQUENTIALLY along the reduced axis —
#     the nditer runs the contiguous axis as the inner vector loop and
#     adds one slice at a time;
#   * np.sum over the contiguous inner axis uses 8-way-unrolled pairwise
#     summation — but the only such reduction here (the degree,
#     flocking_relative.py:120) sums 0/1 floats, which is order-exact.
# Select with ``FlockingParams.parity_exact=True`` (static).  This path
# scans N dependent [N]-adds per reduction — a correctness mode, not the
# perf path.


def _rnd(x: jax.Array) -> jax.Array:
    """Pin an intermediate against value-changing XLA rewrites — above all
    fma contraction of ``a*b + c``, which NumPy never applies (measured:
    140/900 r2 entries differed by 1 ULP through it) — so the arithmetic
    matches NumPy's op-for-op.

    Implementation note: a data-dependent select is the only formulation
    measured to actually block contraction on this toolchain;
    ``optimization_barrier``, ``reduce_precision(11, 52)`` and an
    int64 bitcast round-trip are all looked through or canonicalized
    away.  ``x == x`` is unknowable at compile time, so the select (and
    the rounding of its operand) must survive.  Caveat: NaN inputs map
    to 0 — parity-mode states are finite by construction (the reference
    would have produced NaN trajectories otherwise)."""
    return jnp.where(x == x, x, jnp.zeros_like(x))


def _opaque_div(a: jax.Array, n) -> jax.Array:
    """``a / n`` with the divisor hidden from constant folding.

    XLA's algebraic simplifier rewrites division by a known constant into
    multiplication by the (rounded!) reciprocal — e.g. ``/ 50`` becomes
    ``* 0.02`` — which NumPy never does; measured: ~22% of random states
    got a 1-ULP different instant_cost through that rewrite alone.  A
    barrier'd divisor stays a real division."""
    return a / jax.lax.optimization_barrier(jnp.asarray(n, a.dtype))


def _np_pairwise_sum(v: jax.Array):
    """Sum of a 1-D vector in NumPy's exact accumulation order for a
    CONTIGUOUS inner-axis reduce: the 8-way-unrolled pairwise algorithm
    (numpy pairwise_sum, loops.c.src — stable across NumPy releases and
    pinned empirically by test_flocking_parity).  Static-shape Python
    unroll: ~n scalar adds in the graph, a parity-mode cost only."""
    n = v.shape[0]
    if n < 8:
        s = v[0]
        for i in range(1, n):
            s = s + v[i]
        return s
    if n <= 128:
        r = [v[i] for i in range(8)]
        i = 8
        while i + 8 <= n:
            for j in range(8):
                r[j] = r[j] + v[i + j]
            i += 8
        s = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        while i < n:
            s = s + v[i]
            i += 1
        return s
    ns = n // 2
    ns -= ns % 8
    return _np_pairwise_sum(v[:ns]) + _np_pairwise_sum(v[ns:])


def _seq_sum_cols(a: jax.Array) -> jax.Array:
    """[N, M] -> [N]: sum over axis 1, accumulating sequentially in j —
    np.add.reduce's order for a non-inner reduction axis."""

    def body(acc, col):
        return acc + col, None

    acc, _ = jax.lax.scan(body, jnp.zeros_like(a[:, 0]), jnp.swapaxes(a, 0, 1))
    return acc


def _seq_sum_rows(a: jax.Array) -> jax.Array:
    """[N, C] -> [C]: sum over axis 0, sequential in i (np.add.reduce)."""

    def body(acc, row):
        return acc + row, None

    acc, _ = jax.lax.scan(body, jnp.zeros_like(a[0]), a)
    return acc


def flocking_features_exact(
    x: jax.Array,
    comm_radius2,
    obstacle_mask: jax.Array | None = None,
):
    """compute_helpers with the reference's exact op order
    (flocking_relative.py:111-134): direct divisions (``dx / (r2*r2)``,
    not reciprocal-multiplies), per-element division for the mean-pooled
    adjacency, sequential-j neighbor sums."""
    dx, dy, dvx, dvy, r2 = _pairwise_channels(x, obstacle_mask, exact=True)
    adj = (r2 < comm_radius2).astype(x.dtype)
    # degree: 0/1 sums are order-exact; clamp zeros to 1 (:121)
    deg = jnp.sum(adj, axis=1)
    deg = jnp.where(deg == 0.0, 1.0, deg)
    adj_mean = adj / deg[:, None]
    r4 = r2 * r2
    chans = (dvx, dx / r4, dx / r2, dvy, dy / r4, dy / r2)
    state_values = jnp.stack(
        [_seq_sum_cols(_rnd(c * adj)) for c in chans], axis=1
    )
    return state_values, adj, adj_mean, r2


def turner_controller_exact(
    x: jax.Array,
    params: FlockingParams,
    centralized: bool | None = None,
    obstacle_mask: jax.Array | None = None,
) -> jax.Array:
    """controller() with the reference's exact op order
    (flocking_relative.py:194-226): potential_grad as two divisions,
    sequential-j sums of the stacked potentials."""
    if centralized is None:
        centralized = params.centralized
    dx, dy, dvx, dvy, r2 = _pairwise_channels(x, obstacle_mask, exact=True)
    r4 = r2 * r2
    gx = _rnd(-2.0 * (dx / r4)) + _rnd(2.0 * (dx / r2))
    gx = jnp.where(r2 > params.comm_radius, 0.0, gx)
    gy = _rnd(-2.0 * (dy / r4)) + _rnd(2.0 * (dy / r2))
    gy = jnp.where(r2 > params.comm_radius, 0.0, gy)
    chans = [dvx, dvy, gx, gy]  # p_sum columns 2, 3, 4, 5
    if not centralized:
        adj = (r2 < params.comm_radius2).astype(x.dtype)
        chans = [c * adj for c in chans]
    s_dvx, s_dvy, s_gx, s_gy = (_seq_sum_cols(_rnd(c)) for c in chans)
    controls = jnp.stack((-s_gx - s_dvx, -s_dvy - s_gy), axis=1)
    controls = jnp.clip(controls, -10.0, 10.0)
    return _opaque_div(controls, params.action_scalar)


def _instant_cost_exact(x: jax.Array) -> jax.Array:
    """instant_cost with np.var's exact order (flocking_relative.py:145-147):
    sequential axis-0 mean, squared residuals, sequential axis-0 mean."""
    v = x[:, 2:4]
    n = v.shape[0]
    m = _opaque_div(_seq_sum_rows(v), n)
    d = v - m
    var = _opaque_div(_seq_sum_rows(_rnd(d * d)), n)
    return -1.0 * (var[0] + var[1])


def flocking_obs_expert_pass(
    x: jax.Array,
    params: FlockingParams,
    centralized: bool = True,
    obstacle_mask: jax.Array | None = None,
):
    """ONE pairwise pass producing everything the observation AND the Turner
    expert need at state ``x``.

    The unfused loop runs two O(N^2) passes per step — the expert at x_t
    (reference flocking_relative.py:194-212) and the observation at x_{t+1}
    (:111-134) — at DIFFERENT states, so XLA cannot CSE them.  Carrying this
    pass's expert sums across a rollout scan (see
    :meth:`FlockingRelativeEnv.expert_rollout`) serves step t's observation
    and step t+1's expert from the same channels: one pass per step.

    Returns ``(values [N,6], network [N,N], s_gx [N], s_gy [N], s_dvx [N],
    s_dvy [N])`` where the last four are the expert's summed potential
    gradients and velocity differences (adjacency-masked when
    ``centralized=False``).  The arithmetic is the exact primitive sequence
    of :func:`flocking_features` + :func:`turner_controller` (shared
    channels CSE'd by XLA), so the fused rollout matches the unfused loop to
    float rounding (XLA fusion may reassociate the reductions).
    """
    dx, dy, dvx, dvy, r2 = _pairwise_channels(x, obstacle_mask)
    adj = radius_adjacency(r2, params.comm_radius2)
    adj_mean = mean_pool_normalize(adj)

    inv = 1.0 / r2
    inv2 = inv * inv
    values = jnp.stack(
        (
            jnp.sum(dvx * adj, axis=1),
            jnp.sum(dx * inv2 * adj, axis=1),
            jnp.sum(dx * inv * adj, axis=1),
            jnp.sum(dvy * adj, axis=1),
            jnp.sum(dy * inv2 * adj, axis=1),
            jnp.sum(dy * inv * adj, axis=1),
        ),
        axis=1,
    )
    network = adj_mean if params.mean_pooling else adj

    gx = turner_potential_grad(dx, r2, params.comm_radius)
    gy = turner_potential_grad(dy, r2, params.comm_radius)
    if not centralized:
        # decentralized velocity-consensus sums ARE feature channels 0/3
        # (CSE'd — no extra reductions)
        gx = gx * adj
        gy = gy * adj
        s_dvx = values[:, 0]
        s_dvy = values[:, 3]
    elif obstacle_mask is None:
        # sum_j (v_i - v_j) = N v_i - sum_j v_j: the closed form drops two
        # unmasked [N, N] reductions (measured +6% on the fused rollout);
        # exact identity in exact arithmetic, float-rounding-level
        # difference vs the row sums
        n = x.shape[0]
        s_dvx = n * x[:, 2] - jnp.sum(x[:, 2])
        s_dvy = n * x[:, 3] - jnp.sum(x[:, 3])
    else:
        # the obstacle variant zeroes dvx rows/cols inside the pairwise
        # channels (flocking_obstacle.py:80-81) — the closed form would not
        # see the zeroing, so keep the masked row sums
        s_dvx = jnp.sum(dvx, axis=1)
        s_dvy = jnp.sum(dvy, axis=1)
    return (
        values,
        network,
        jnp.sum(gx, axis=1),
        jnp.sum(gy, axis=1),
        s_dvx,
        s_dvy,
    )


def _instant_cost(x: jax.Array) -> jax.Array:
    """-sum of velocity variances (reference flocking_relative.py:145-147)."""
    v = x[:, 2:4]
    return -1.0 * jnp.sum(jnp.var(v, axis=0))


def _integrate(x: jax.Array, u: jax.Array, dt, mask: jax.Array | None = None,
               exact: bool = False) -> jax.Array:
    """Euler double-integrator update (reference flocking_relative.py:98-105).

    ``mask`` (float [N], 0 = frozen agent) reproduces the leader/obstacle
    variants where masked agents ignore their control input
    (flocking_leader.py:27-31, flocking_obstacle.py:41-47).
    ``exact``: round every product before it feeds an add (parity mode —
    blocks XLA's fma contraction, which NumPy never applies).
    """
    ux, uy = u[:, 0], u[:, 1]
    if mask is not None:
        ux_eff = ux * mask
        uy_eff = uy * mask
    else:
        ux_eff, uy_eff = ux, uy
    rnd = _rnd if exact else (lambda t: t)
    px = x[:, 0] + rnd(x[:, 2] * dt) + rnd(ux_eff * dt * dt * 0.5)
    py = x[:, 1] + rnd(x[:, 3] * dt) + rnd(uy_eff * dt * dt * 0.5)
    vx = x[:, 2] + rnd(ux_eff * dt)
    vy = x[:, 3] + rnd(uy_eff * dt)
    return jnp.stack((px, py, vx, vy), axis=1)


# =============================================================================
# Envs
# =============================================================================


class FlockingRelativeEnv(Env[FlockingParams, FlockingState]):
    """100-agent 2D double-integrator swarm with relative-feature observations.

    Observation: ``(state_values [N,6], state_network [N,N])`` exactly as the
    reference returns from ``step``/``reset`` (flocking_relative.py:109, 192).
    Reward: negative sum of velocity variances.  Never terminates on its own
    (reference returns done=False); time-limit truncation at
    ``params.max_steps`` mirrors gym registration (gym_flock/__init__.py:62).
    """

    def default_params(self) -> FlockingParams:
        return FlockingParams()

    # ------------------------------------------------------------ helpers

    def _obs(self, state: FlockingState, params: FlockingParams):
        features = (
            flocking_features_exact if params.parity_exact else flocking_features
        )
        values, adj, adj_mean, _ = features(
            state.x, params.comm_radius2, self._obstacle_mask(params)
        )
        network = adj_mean if params.mean_pooling else adj
        return values, network

    def _obstacle_mask(self, params: FlockingParams):
        return None

    def _integration_mask(self, params: FlockingParams):
        return None

    def _action_scale(self, params: FlockingParams):
        return params.action_scalar

    def _reset_accept(self, x: jax.Array, params: FlockingParams) -> jax.Array:
        """Acceptance test of the rejection-sampling reset (reference
        flocking_relative.py:164): min degree >= 2 and min pairwise
        distance > ``min_dist_thresh``.  Dense O(N^2); the cell-list
        variant overrides with the O(N) test."""
        _, _, _, _, r2 = _pairwise_channels(x)
        min_dist = jnp.sqrt(jnp.min(r2))
        degree = jnp.min(jnp.sum(r2 < params.comm_radius2, axis=1))
        return (degree >= 2) & (min_dist > params.min_dist_thresh)

    # ------------------------------------------------------------ protocol

    def reset_env(self, key: jax.Array, params: FlockingParams):
        """Rejection-sampling reset (reference flocking_relative.py:156-192).

        Redraw until min degree >= 2 and min pairwise distance >
        ``min_dist_thresh``; bounded at ``params.max_reset_tries`` trips
        (the reference loops unboundedly — SURVEY.md §5.9b).
        """
        n = params.n_agents

        def draw(key):
            k1, k2, k3, k4, k5 = jax.random.split(key, 5)
            length = jnp.sqrt(
                jax.random.uniform(k1, (n,), minval=0.0, maxval=params.r_max_eff)
            )
            angle = jnp.pi * jax.random.uniform(k2, (n,), minval=0.0, maxval=2.0)
            bias = jax.random.uniform(
                k3, (2,), minval=-params.v_bias, maxval=params.v_bias
            )
            vx = jax.random.uniform(k4, (n,), minval=-params.v_max, maxval=params.v_max)
            vy = jax.random.uniform(k5, (n,), minval=-params.v_max, maxval=params.v_max)
            x = jnp.stack(
                (
                    length * jnp.cos(angle),
                    length * jnp.sin(angle),
                    vx + bias[0],
                    vy + bias[1],
                ),
                axis=1,
            )
            return x

        def accept(x):
            return self._reset_accept(x, params)

        def cond(carry):
            _, _, ok, tries = carry
            return (~ok) & (tries < params.max_reset_tries)

        def body(carry):
            key, _, _, tries = carry
            key, sub = jax.random.split(key)
            x = draw(sub)
            return key, x, accept(x), tries + 1

        key0, sub0 = jax.random.split(key)
        x0 = draw(sub0)
        _, x, _, _ = jax.lax.while_loop(
            cond, body, (key0, x0, accept(x0), jnp.int32(1))
        )

        state = FlockingState(
            time=jnp.int32(0),
            x=x,
            mean_vel=jnp.mean(x[:, 2:4], axis=0),
            init_vel=x[:, 2:4],
        )
        return state, self._obs(state, params)

    def init_state(self, x: jax.Array, params: FlockingParams) -> FlockingState:
        """Build a state from an externally supplied [N,4] array.

        This is the parity-mode entry point: a host-side NumPy reset
        emulating the reference's legacy RNG streams feeds device states
        (SURVEY.md §7 'hard parts' (i))."""
        x = jnp.asarray(x)
        return FlockingState(
            time=jnp.int32(0),
            x=x,
            mean_vel=jnp.mean(x[:, 2:4], axis=0),
            init_vel=x[:, 2:4],
        )

    def step_env(self, key, state: FlockingState, action, params: FlockingParams):
        u = action * self._action_scale(params)
        x = _integrate(state.x, u, params.dt, self._integration_mask(params),
                       exact=params.parity_exact)
        new_state = state.replace(x=x, time=state.time + 1)
        obs = self._obs(new_state, params)
        cost = _instant_cost_exact if params.parity_exact else _instant_cost
        reward = cost(x)
        done = new_state.time >= params.max_steps
        return new_state, obs, reward, done, {}

    def controller(self, state: FlockingState, params: FlockingParams, centralized=None):
        ctrl = turner_controller_exact if params.parity_exact else turner_controller
        return ctrl(state.x, params, centralized, self._obstacle_mask(params))

    # ---------------------------------------------------- fused expert rollout

    def _fused_pass(self, x: jax.Array, params: FlockingParams, centralized: bool):
        """(values, network, s_gx, s_gy, s_dvx, s_dvy) at ``x`` — see
        :func:`flocking_obs_expert_pass`.  Subclasses with their own kernels
        (Large/Sparse) override."""
        return flocking_obs_expert_pass(
            x, params, centralized, self._obstacle_mask(params)
        )

    def _fused_carry_init(self, x: jax.Array, params: FlockingParams):
        """Optional cross-step state threaded through the fused rollout scan.

        ``None`` (an empty pytree) for the dense variants; the sparse env
        returns a ``VerletState`` so the Hilbert sort is rebuilt only on
        drift."""
        return None

    def _fused_pass_carry(self, x, params, centralized, carry):
        """Carry-aware fused pass: ``((values, network, gx, gy, dvx, dvy),
        carry')``.  Variants with cross-step kernel state override this
        pair of hooks instead of duplicating the rollout scan."""
        return self._fused_pass(x, params, centralized), carry

    def expert_rollout(
        self,
        state: FlockingState,
        params: FlockingParams,
        n_steps: int,
        centralized: bool | None = None,
        key: jax.Array | None = None,
    ):
        """Closed-loop Turner-expert rollout with the obs/expert pairwise
        pass fused ACROSS steps.

        The naive loop (``u = controller(state); step(u)``) runs two O(N^2)
        passes per step at different states.  Here the pass at x_{t+1}
        produced for step t's observation is carried forward and its expert
        sums drive step t+1's action — ONE pairwise pass per step, halving
        the dominant cost (reference semantics unchanged: the expert still
        acts on the current state exactly as flocking_relative.py:194-212;
        the trajectory matches the unfused loop to float rounding).

        For the cell-list variant this also means ONE Hilbert sort + block
        table per step instead of two (ROADMAP #15).

        Returns ``(final_state, traj)`` with ``traj`` a dict of stacked
        per-step arrays: ``u`` (the expert action taken at step t, i.e. the
        imitation label for the obs returned by step t-1), ``values``,
        ``network``, ``reward``.  ``key`` feeds variants with stochastic
        dynamics (FlockingStochastic's per-step dt); deterministic variants
        ignore it.

        The traj ``values`` field is each variant's own observation
        (relative features; the top-k neighbor table for
        :class:`FlockingAbsoluteEnv`).
        """
        if centralized is None:
            centralized = params.centralized
        if key is None:
            key = jax.random.key(0)

        fc0 = self._fused_carry_init(state.x, params)
        (_, _, gx0, gy0, dvx0, dvy0), fc0 = self._fused_pass_carry(
            state.x, params, centralized, fc0
        )

        def body(carry, key_t):
            x, s_gx, s_gy, s_dvx, s_dvy, fc = carry
            controls = jnp.stack((-s_gx - s_dvx, -s_dvy - s_gy), axis=1)
            u = self._rollout_action(controls, params)
            x1 = self._rollout_integrate(x, u, params, key_t)
            (values, network, s_gx1, s_gy1, s_dvx1, s_dvy1), fc = (
                self._fused_pass_carry(x1, params, centralized, fc)
            )
            reward = _instant_cost(x1)
            return (x1, s_gx1, s_gy1, s_dvx1, s_dvy1, fc), {
                "u": u,
                "values": values,
                "network": network,
                "reward": reward,
            }

        (x_f, *_), traj = jax.lax.scan(
            body,
            (state.x, gx0, gy0, dvx0, dvy0, fc0),
            jax.random.split(key, n_steps),
        )
        final = state.replace(x=x_f, time=state.time + n_steps)
        return final, traj

    def _rollout_action(self, controls, params: FlockingParams):
        """Raw expert sums -> action (reference flocking_relative.py:208-211)."""
        return jnp.clip(controls, -10.0, 10.0) / params.action_scalar

    def _rollout_integrate(self, x, u, params: FlockingParams, key):
        """One dynamics step inside the fused rollout (variants override)."""
        return _integrate(
            x, u * self._action_scale(params), params.dt,
            self._integration_mask(params),
        )

    def potential(self, state: FlockingState, params: FlockingParams) -> jax.Array:
        """Total Turner potential (reference flocking_relative.py:228-232):
        sum of 1/r^2 + log(r^2) with out-of-range pairs clamped to the value
        at the communication radius and the diagonal zeroed."""
        _, _, _, _, r2 = _pairwise_channels(state.x)
        cr2 = params.comm_radius2
        vr = 1.0 / cr2 + jnp.log(cr2)
        p = 1.0 / r2 + jnp.log(r2)
        p = jnp.where(r2 > cr2, vr, p)
        n = params.n_agents
        # iota-equality diagonal mask, consistent with _pairwise_channels
        # (jnp.eye materializes an [N, N] operand that blocks reduce fusion)
        eye = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0) == (
            jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
        )
        p = jnp.where(eye, 0.0, p)
        return jnp.sum(p)

    def get_stats(self, state: FlockingState) -> Dict[str, jax.Array]:
        """vel_diffs / min_dists (reference flocking_relative.py:136-143)."""
        v = state.x[:, 2:4]
        vel_diffs = jnp.sqrt(jnp.sum((v - jnp.mean(v, axis=0)) ** 2, axis=1))
        _, _, _, _, r2 = _pairwise_channels(state.x)
        min_dists = jnp.min(jnp.sqrt(r2), axis=0)
        return {"vel_diffs": vel_diffs, "min_dists": min_dists}

    # ------------------------------------------------------------ spaces

    def observation_space(self, params: FlockingParams):
        return Box(-jnp.inf, jnp.inf, (params.n_agents, 6))

    def action_space(self, params: FlockingParams):
        return Box(-params.max_accel, params.max_accel, (params.n_agents, 2))


class FlockingAbsoluteEnv(FlockingRelativeEnv):
    """``Flocking-v0``: observations are state diffs to the 7 nearest agents.

    Reference flocking/flocking.py:20-25: ``obs[:, i*4:(i+1)*4] =
    x - x[nearest[:, i]]`` for the i-th nearest neighbor by r^2 (diagonal is
    Inf so self is excluded).  Python loop over k becomes a top_k gather.
    """

    def _obs(self, state: FlockingState, params: FlockingParams):
        x = state.x
        _, adj, adj_mean, r2 = flocking_features(x, params.comm_radius2)
        k = params.n_neighbors
        _, idx = jax.lax.top_k(-r2, k)  # [N, k] nearest by ascending r2
        rel = x[:, None, :] - x[idx, :]  # [N, k, 4]
        obs = rel.reshape(params.n_agents, k * 4)
        network = adj_mean if params.mean_pooling else adj
        return obs, network

    def observation_space(self, params: FlockingParams):
        return Box(-jnp.inf, jnp.inf, (params.n_agents, params.n_neighbors * 4))

    def _fused_pass(self, x, params, centralized):
        """Absolute-obs fused pass: the top-k neighbor table shares the
        SAME pairwise r2 with the expert sums, so the fused rollout's
        ``values`` field is this env's real observation."""
        dx, dy, dvx, dvy, r2 = _pairwise_channels(x)
        adj = radius_adjacency(r2, params.comm_radius2)
        network = mean_pool_normalize(adj) if params.mean_pooling else adj
        _, idx = jax.lax.top_k(-r2, params.n_neighbors)
        rel = x[:, None, :] - x[idx, :]
        obs = rel.reshape(params.n_agents, params.n_neighbors * 4)
        gx = turner_potential_grad(dx, r2, params.comm_radius)
        gy = turner_potential_grad(dy, r2, params.comm_radius)
        if not centralized:
            gx = gx * adj
            gy = gy * adj
            s_dvx = jnp.sum(dvx * adj, axis=1)
            s_dvy = jnp.sum(dvy * adj, axis=1)
        else:
            n = x.shape[0]
            s_dvx = n * x[:, 2] - jnp.sum(x[:, 2])
            s_dvy = n * x[:, 3] - jnp.sum(x[:, 3])
        return obs, network, jnp.sum(gx, axis=1), jnp.sum(gy, axis=1), s_dvx, s_dvy


class FlockingLeaderEnv(FlockingRelativeEnv):
    """``FlockingLeader-v0``: first ``n_leaders`` agents ignore control input.

    Reference flocking_leader.py:21-40.  Parity quirks preserved: the leader
    variant does NOT scale actions by ``action_scalar`` (:24 assigns
    ``self.u = u``), and at reset all leaders share one uniform random
    velocity in both components (:38-39 draws size=(1,1) and broadcasts).
    """

    def _integration_mask(self, params: FlockingParams):
        n = params.n_agents
        return (jnp.arange(n) >= params.n_leaders).astype(jnp.float32)

    def _action_scale(self, params: FlockingParams):
        return 1.0

    def reset_env(self, key, params):
        key, sub = jax.random.split(key)
        state, obs = super().reset_env(key, params)
        lead_v = jax.random.uniform(
            sub, (1, 1), minval=-params.v_max, maxval=params.v_max
        )
        x = state.x.at[0 : params.n_leaders, 2:4].set(
            jnp.ones((params.n_leaders, 2)) * lead_v
        )
        state = state.replace(x=x)
        # the reference overrides leader velocities AFTER compute_helpers and
        # returns the stale pre-override observation (flocking_leader.py:36-40)
        return state, obs

    def default_params(self) -> FlockingParams:
        return FlockingParams(max_steps=200)


def _grid_formation(n: int, side: int = 5, dtype=None) -> jax.Array:
    """0.8-spaced centered grid (reference flocking/utils.py:23-30)."""
    from gym_flock_tpu.utils.formations import grid as _np_grid

    return jnp.asarray(_np_grid(n, side), dtype=dtype or jnp.zeros(0).dtype)


class FlockingObstacleEnv(FlockingRelativeEnv):
    """``FlockingObstacle-v0``: first ``n_obstacles`` agents are frozen blocks.

    Reference flocking_obstacle.py:13-104.  Deterministic reset: swarm on a
    0.8-grid moving at (0, -7); obstacles on a half-scale 2-wide grid shifted
    down 10 units, zero velocity (:58-73).  Obstacle velocity rows/cols are
    zeroed in the pairwise diff before features (:80-81).  Actions are NOT
    scaled by action_scalar (:38).  ``r_max`` is 3.0 (:22) — render-only.
    """

    def _obstacle_mask(self, params: FlockingParams):
        return jnp.arange(params.n_agents) < params.n_obstacles

    def _integration_mask(self, params: FlockingParams):
        return (jnp.arange(params.n_agents) >= params.n_obstacles).astype(jnp.float32)

    def _action_scale(self, params: FlockingParams):
        return 1.0

    def reset_env(self, key, params):
        n, n_obs = params.n_agents, params.n_obstacles
        pos = _grid_formation(n)
        x = jnp.concatenate(
            (pos, jnp.tile(jnp.asarray([[0.0, -7.0]]), (n, 1))), axis=1
        )
        obs_pos = _grid_formation(n_obs, side=2) * 0.5
        obs_pos = obs_pos.at[:, 1].add(-10.0)
        x = x.at[:n_obs, 0:2].set(obs_pos)
        x = x.at[:n_obs, 2:4].set(0.0)

        state = FlockingState(
            time=jnp.int32(0),
            x=x,
            mean_vel=jnp.mean(x[n_obs:, 2:4], axis=0),
            init_vel=x[n_obs:, 2:4],
        )
        return state, self._obs(state, params)

    def default_params(self) -> FlockingParams:
        return FlockingParams(max_steps=200, r_max=3.0, auto_scale_r_max=False)


class FlockingStochasticEnv(FlockingRelativeEnv):
    """``FlockingStochastic-v0``: random dt ~ N(0.12, 0.018) per step.

    Reference flocking_stoch.py:14-45: clip u to +-0.5, scale state and
    control by 6 before integrating, unscale after; the expert clips its
    output to +-max_accel.
    """

    def step_env(self, key, state: FlockingState, action, params: FlockingParams):
        dt = params.dt_mean + params.dt_sigma * jax.random.normal(key, ())
        return self.step_with_dt(state, action, dt, params)

    def step_with_dt(self, state: FlockingState, action, dt, params: FlockingParams):
        """Step with an externally supplied dt.

        Parity entry point: feed dts replayed from the reference's global
        ``np.random`` stream (``compat.parity.reference_stochastic_dt``) to
        reproduce reference trajectories seed-exactly
        (tests/test_parity_reset.py).
        """
        u = jnp.clip(action, -params.stoch_max_accel, params.stoch_max_accel)
        u = u * params.stoch_scale
        x = state.x * params.stoch_scale
        x = _integrate(x, u, dt)
        x = x / params.stoch_scale
        new_state = state.replace(x=x, time=state.time + 1)
        obs = self._obs(new_state, params)
        return new_state, obs, _instant_cost(x), new_state.time >= params.max_steps, {}

    def controller(self, state, params, centralized=None):
        u = turner_controller(state.x, params, centralized)
        return jnp.clip(u, -params.stoch_max_accel, params.stoch_max_accel)

    def _rollout_action(self, controls, params):
        u = jnp.clip(controls, -10.0, 10.0) / params.action_scalar
        return jnp.clip(u, -params.stoch_max_accel, params.stoch_max_accel)

    def _rollout_integrate(self, x, u, params, key):
        # step_with_dt semantics with dt drawn per step from the rollout key
        dt = params.dt_mean + params.dt_sigma * jax.random.normal(key, ())
        u = jnp.clip(u, -params.stoch_max_accel, params.stoch_max_accel)
        x = _integrate(x * params.stoch_scale, u * params.stoch_scale, dt)
        return x / params.stoch_scale

    def default_params(self) -> FlockingParams:
        return FlockingParams(max_steps=500)


class FlockingTwoFlocksEnv(FlockingRelativeEnv):
    """``FlockingTwoFlocks-v0``: reset to a grid with inward velocities.

    Reference flocking_twoflocks.py:8-26: x = grid(n, side=n/10),
    v = -grid + bias with bias ~ U(-v_bias/2, v_bias/2)^2.
    """

    def reset_env(self, key, params):
        n = params.n_agents
        bias = jax.random.uniform(
            key, (2,), minval=-params.v_bias / 2.0, maxval=params.v_bias / 2.0
        )
        grids = _grid_formation(n, side=int(n / 10))
        x = jnp.concatenate((grids, -grids + bias[None, :]), axis=1)
        state = FlockingState(
            time=jnp.int32(0),
            x=x,
            mean_vel=jnp.mean(x[:, 2:4], axis=0),
            init_vel=x[:, 2:4],
        )
        return state, self._obs(state, params)

    def default_params(self) -> FlockingParams:
        return FlockingParams(max_steps=500)


class LargeFlockingEnv(FlockingRelativeEnv):
    """Large-swarm variant (N >~ 1k): fused observation/expert pass.

    Same dynamics, reward, and expert semantics as FlockingRelativeEnv, but
    the observation is ``(state_values [N,6], degree [N])`` instead of
    ``(values, adjacency [N,N])`` — at this scale a dense adjacency is the
    memory bottleneck (SURVEY.md §5.7), so consumers aggregate through
    ``gym_flock_tpu.ops.adjacency_matmul`` / ``khop_aggregate`` instead of
    receiving A.  All pairwise reductions run through the fused
    ``ops.pallas_flocking.flocking_sums`` pass (O(N) memory traffic);
    ``jax.vmap`` over this env is native.
    """

    def _obs(self, state: FlockingState, params: FlockingParams):
        from gym_flock_tpu.ops.pallas_flocking import flocking_features_large

        values, degree = flocking_features_large(
            state.x, params.comm_radius, params.comm_radius2
        )
        return values, degree

    def controller(self, state, params, centralized=None):
        from gym_flock_tpu.ops.pallas_flocking import turner_controller_large

        if centralized is None:
            centralized = params.centralized
        return turner_controller_large(
            state.x,
            params.comm_radius,
            params.comm_radius2,
            params.action_scalar,
            centralized=centralized,
        )

    def observation_space(self, params: FlockingParams):
        return Box(-jnp.inf, jnp.inf, (params.n_agents, 6))

    def _sums(self, x, params, channels: str = "core"):
        from gym_flock_tpu.ops.pallas_flocking import (
            flocking_sums,
            flocking_sums_block,
        )

        if channels == "core":
            return flocking_sums(x, params.comm_radius, params.comm_radius2)
        # expert channels (10/11: adjacency-masked grad sums) live in the
        # "full" set of the cross-block pass
        return flocking_sums_block(
            x, x, 0, 0, params.comm_radius, params.comm_radius2
        )

    def _unpack_sums(self, s, x, centralized):
        """``(values, network, gx, gy, dvx, dvy)`` from one 16-channel sums
        tensor (the SINGLE owner of the channel layout — the blockwise and
        cell-list kernels share it):

        0-5 obs features, 8 degree; 6/7 potential-grad sums (centralized
        expert) or 10/11 adjacency-masked grad sums (decentralized,
        reference flocking_relative.py:201-207).  Centralized velocity-
        difference sums collapse to the closed form; decentralized ones ARE
        feature channels 0/3.
        """
        values, network = s[..., 0:6], s[..., 8]
        if centralized:
            n = x.shape[0]
            gx, gy = s[..., 6], s[..., 7]
            dvx = n * x[:, 2] - jnp.sum(x[:, 2])
            dvy = n * x[:, 3] - jnp.sum(x[:, 3])
        else:
            gx, gy = s[..., 10], s[..., 11]
            dvx, dvy = s[..., 0], s[..., 3]
        return values, network, gx, gy, dvx, dvy

    def _fused_pass(self, x, params, centralized):
        # flocking_sums produces obs AND expert channels in one fused
        # pass; see _unpack_sums for the layout
        s = self._sums(x, params, channels="core" if centralized else "expert")
        return self._unpack_sums(s, x, centralized)

    def default_params(self) -> FlockingParams:
        return FlockingParams(n_agents=4096, max_steps=1000)


class SparseFlockingEnv(LargeFlockingEnv):
    """Cell-list variant: O(N) pairwise work instead of O(N^2).

    Same semantics as :class:`LargeFlockingEnv` (adjacency-masked sums are
    EXACT — the Hilbert-sort + bbox block pruning of
    ``ops.sparse_flocking`` only removes pairs with zero contribution; only
    float summation order differs), but the observation and the centralized
    expert scale with the neighbor count, not the swarm size.  Requires ``n_agents`` a multiple of 128.  Pathologically
    clustered swarms exceed the candidate-table capacity and fall back to
    the dense kernel for the batch — never wrong, only slower.
    """

    def _sums(self, x, params, channels: str = "core"):
        from gym_flock_tpu.ops.sparse_flocking import flocking_sums_sparse

        return flocking_sums_sparse(
            x, params.comm_radius, params.comm_radius2, channels=channels
        )

    def _reset_accept(self, x, params):
        # the inherited dense test would materialize O(N^2) pairwise
        # temporaries (~1 GB f32 at the default N=16384) per rejection draw;
        # the cell-list test is exact and O(N * k_max * 128)
        from gym_flock_tpu.ops.sparse_flocking import sparse_reset_accept

        return sparse_reset_accept(
            x, params.comm_radius, params.comm_radius2, params.min_dist_thresh
        )

    def _obs(self, state: FlockingState, params: FlockingParams):
        s = self._sums(state.x, params)
        return s[..., 0:6], s[..., 8]

    def controller(self, state, params, centralized=None):
        if centralized is None:
            centralized = params.centralized
        x = state.x
        s = self._sums(x, params, channels="core" if centralized else "expert")
        _, _, s_gx, s_gy, s_dvx, s_dvy = self._unpack_sums(s, x, centralized)
        controls = jnp.stack((-s_gx - s_dvx, -s_dvy - s_gy), axis=1)
        return jnp.clip(controls, -10.0, 10.0) / params.action_scalar

    # ------------------------------------------- cross-step Verlet rollout
    # The fused rollout scan itself lives in the base class; the sparse env
    # only supplies the carry hooks: a skin-expanded candidate table
    # carried through the scan
    # and rebuilt only when an agent has moved more than ``verlet_skin/2``
    # since the last build — see ops.sparse_flocking.flocking_sums_sparse_verlet
    # for the exactness argument.  ``params.verlet_skin=0`` recovers the
    # every-step rebuild (the base behavior).

    def _verlet_skin(self, params: FlockingParams):
        """Resolved Verlet slack, or ``None`` when reuse is disabled.

        Gating decisions read ONLY static fields (``params.verlet_skin``,
        ``params.n_agents``) so this is safe with ``params`` as a traced
        jit/vmap argument; the resolved VALUE may be the dynamic
        ``comm_radius`` (the ``verlet_skin=None`` default)."""
        from gym_flock_tpu.ops.sparse_flocking import BLOCK

        cfg = params.verlet_skin
        if cfg is not None and cfg <= 0.0:
            return None
        if params.n_agents % BLOCK != 0:
            return None
        return params.comm_radius if cfg is None else cfg

    def _fused_carry_init(self, x, params):
        from gym_flock_tpu.ops.sparse_flocking import verlet_build

        skin = self._verlet_skin(params)
        if skin is None:
            return None
        return verlet_build(x, params.comm_radius, skin)

    def _fused_pass_carry(self, x, params, centralized, carry):
        if carry is None:  # reuse disabled: per-step rebuild via _fused_pass
            return super()._fused_pass_carry(x, params, centralized, carry)
        from gym_flock_tpu.ops.sparse_flocking import flocking_sums_sparse_verlet

        s, carry = flocking_sums_sparse_verlet(
            x, carry, params.comm_radius, params.comm_radius2,
            self._verlet_skin(params),
            channels="core" if centralized else "expert",
        )
        return self._unpack_sums(s, x, centralized), carry

    def default_params(self) -> FlockingParams:
        return FlockingParams(n_agents=16384, max_steps=1000)
