"""Agent-axis sharding for the O(N^2) flocking interaction kernels.

The reference computes all-pairs interactions as one dense [N, N] pass in a
single process (flocking_relative.py:111-134).  One chip runs out of HBM for
that matrix somewhere past N ~ 100k (a dense f32 [N, N] at N=131072 is
64 GiB); the scaling axis the reference cannot touch at all.  Here the
*agent* axis is sharded over a mesh axis: each device owns a row block of
``m = N / P`` agents and computes that block's pairwise reductions

- ``mode="allgather"``: one ``all_gather`` of the swarm state (N x 4 — tiny
  compared to the pair matrix), then a single [m, N] block pass.  Peak
  pairwise footprint O(m * N) per device.
- ``mode="ring"``: column blocks of the swarm stream around a ``ppermute``
  ring; each of the P steps computes an [m, m] tile and accumulates the
  per-row sums.  Peak footprint O(m^2) — the ring-attention schedule applied
  to pairwise interactions (SURVEY.md §5.7).

Both modes compose with the env-batch axis: the canonical mesh is
``make_flock_mesh(dp, ap)`` — ``Mesh(devices.reshape(dp, ap), ("dp", "ap"))``
— with the batched swarm state sharded ``P("dp", "ap")`` over [B, N, 4].
Everything here is written against a named mesh axis and is meant to be
called inside ``jax.shard_map`` (see :func:`agent_sharded_rollout` for the
assembled pattern).

Channel-sum layout matches ``ops.pallas_flocking.flocking_sums`` (module
docstring there): 0-5 observation features, 6/7 Turner gradient sums,
8 degree, 9 per-row min squared distance (the sharded reset acceptance
test, reference flocking_relative.py:164), 10/11 adjacency-masked gradient
sums (decentralized expert).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gym_flock_tpu.envs.flocking import FlockingParams, _integrate

__all__ = [
    "make_flock_mesh",
    "flocking_sums_sharded",
    "flocking_features_sharded",
    "turner_controller_sharded",
    "adjacency_matmul_sharded",
    "khop_aggregate_sharded",
    "flocking_step_sharded",
    "flocking_reset_sharded",
    "agent_sharded_rollout",
]


def make_flock_mesh(dp: int, ap: int, devices=None) -> jax.sharding.Mesh:
    """2-D mesh: env-batch axis ``dp`` x agent axis ``ap`` (the first
    ``dp * ap`` devices, row-major)."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    if devices.size < dp * ap:
        raise ValueError(f"need {dp * ap} devices, have {devices.size}")
    return jax.sharding.Mesh(devices[: dp * ap].reshape(dp, ap), ("dp", "ap"))


def _ring_perm(p: int):
    # device i receives the block held by device (i + 1) % p each step,
    # i.e. source j sends to destination (j - 1) % p
    return [(j, (j - 1) % p) for j in range(p)]


def flocking_sums_sharded(
    x_local: jax.Array,
    comm_radius,
    comm_radius2,
    axis_name: str = "ap",
    mode: str = "ring",
    channels: str = "full",
) -> jax.Array:
    """All per-agent pairwise reductions, agent axis sharded over ``axis_name``.

    ``x_local``: this shard's [m, 4] row block of the global [N, 4] swarm
    (N = m * axis size).  Returns this shard's [m, 12] channel sums — the
    sharded counterpart of ``ops.flocking_sums`` (same channel layout).
    Call inside ``shard_map``.  Each tile is ``ops.flocking_sums_block``
    with global-id offsets; ``channels="core"`` skips the min-r2 and
    masked-gradient channels (9..11 read as zeros).
    """
    from gym_flock_tpu.ops.pallas_flocking import flocking_sums_block

    m = x_local.shape[0]
    p = jax.lax.axis_size(axis_name)
    me = jax.lax.axis_index(axis_name)

    def tile_sums(xc, col_off):
        return flocking_sums_block(
            x_local, xc, me * m, col_off, comm_radius, comm_radius2,
            channels=channels,
        )[:, :12]

    if mode == "allgather":
        x_all = jax.lax.all_gather(x_local, axis_name, tiled=True)
        return tile_sums(x_all, 0)

    if mode != "ring":
        raise ValueError(f"unknown mode {mode!r}")

    perm = _ring_perm(p)

    # own block first, then p-1 permute-and-compute steps (the scan body
    # permutes BEFORE computing so the final iteration's result is used —
    # p-1 collectives total, not p)
    part0 = tile_sums(x_local, me * m)

    def body(carry, s):
        block = jax.lax.ppermute(carry, axis_name, perm)
        src = jnp.mod(me + s, p)
        part = tile_sums(block, src * m)
        return block, part

    _, parts = jax.lax.scan(body, x_local, jnp.arange(1, p))  # [p-1, m, 12]
    parts = jnp.concatenate([part0[None], parts], axis=0)
    # min-r2 (channel 9) combines by min, everything else by sum
    sums = jnp.sum(parts, axis=0)
    return sums.at[:, 9].set(jnp.min(parts[:, :, 9], axis=0))


def flocking_features_sharded(
    x_local: jax.Array,
    comm_radius,
    comm_radius2,
    axis_name: str = "ap",
    mode: str = "ring",
) -> Tuple[jax.Array, jax.Array]:
    """Sharded ``compute_helpers`` (reference flocking_relative.py:111-134):
    returns ``(state_values [m, 6], degree [m])`` for this shard's agents.
    Like ``ops.flocking_features_large``, the dense [N, N] network is never
    materialized; aggregate through :func:`adjacency_matmul_sharded`."""
    s = flocking_sums_sharded(
        x_local, comm_radius, comm_radius2, axis_name, mode, channels="core"
    )
    return s[:, 0:6], s[:, 8]


def turner_controller_sharded(
    x_local: jax.Array,
    params: FlockingParams,
    axis_name: str = "ap",
    mode: str = "ring",
    sums: Optional[jax.Array] = None,
    centralized: Optional[bool] = None,
) -> jax.Array:
    """Turner expert (reference flocking_relative.py:194-212), agent axis
    sharded.  Centralized mode's velocity-consensus term uses the closed
    form ``sum_j (v_i - v_j) = N v_i - sum_j v_j`` — the global velocity sum
    is one ``psum``, not an N^2 pass; decentralized mode (adjacency-masked
    sums, reference :201-207) reads the masked channels 0/3 and 10/11.
    ``centralized`` defaults to ``params.centralized`` like the dense
    expert.  Pass precomputed ``sums`` (from :func:`flocking_sums_sharded`)
    to share the pairwise pass with the observation kernel, as the fused
    step does."""
    if centralized is None:
        centralized = params.centralized
    m = x_local.shape[0]
    n = m * jax.lax.axis_size(axis_name)
    if sums is None:
        sums = flocking_sums_sharded(
            x_local, params.comm_radius, params.comm_radius2, axis_name, mode,
            channels="core" if centralized else "full",
        )
    if centralized:
        s_gx, s_gy = sums[:, 6], sums[:, 7]
        v_tot = jax.lax.psum(jnp.sum(x_local[:, 2:4], axis=0), axis_name)
        s_dvx = n * x_local[:, 2] - v_tot[0]
        s_dvy = n * x_local[:, 3] - v_tot[1]
    else:
        s_gx, s_gy = sums[:, 10], sums[:, 11]
        s_dvx, s_dvy = sums[:, 0], sums[:, 3]
    controls = jnp.stack((-s_gx - s_dvx, -s_dvy - s_gy), axis=1)
    return jnp.clip(controls, -10.0, 10.0) / params.action_scalar


def adjacency_matmul_sharded(
    x_local: jax.Array,
    h_local: jax.Array,
    comm_radius2,
    axis_name: str = "ap",
    mode: str = "ring",
    mean_pool: bool = True,
) -> jax.Array:
    """(A(x) @ H) with both operands sharded along the agent axis.

    The GNN aggregation primitive (reference flocking_relative.py:117-122 /
    old/flocking_multi.py:180-266) at swarm sizes where neither A nor the
    full H fits one device: each ring step contracts this shard's rows
    against the visiting [m, F] feature block through
    ``ops.adjacency_matmul_block`` (on the GPU the [m, m] adjacency tile is
    built in registers, never in device memory).  ``mean_pool`` divides by
    degree exactly like ``ops.mean_pool_normalize`` (zero-degree rows pass
    through unscaled).
    """
    from gym_flock_tpu.ops.pallas_flocking import adjacency_matmul_block

    m = x_local.shape[0]
    p = jax.lax.axis_size(axis_name)
    me = jax.lax.axis_index(axis_name)

    def tile_mm(xc, hb, col_off):
        out, deg = adjacency_matmul_block(
            x_local, xc, hb, me * m, col_off, comm_radius2
        )
        return out, deg.astype(h_local.dtype)

    if mode == "allgather":
        x_all = jax.lax.all_gather(x_local, axis_name, tiled=True)
        h_all = jax.lax.all_gather(h_local, axis_name, tiled=True)
        out, deg = tile_mm(x_all, h_all, 0)
    elif mode == "ring":

        def body(carry, s):
            xb, hb, acc, deg = carry
            # permute FIRST so the last iteration's blocks are consumed —
            # p-1 collectives per pass, and one ppermute over the (x, h)
            # tuple rather than two
            xb, hb = jax.lax.ppermute((xb, hb), axis_name, _ring_perm(p))
            src = jnp.mod(me + s, p)
            o, d = tile_mm(xb, hb, src * m)
            return (xb, hb, acc + o, deg + d), None

        acc0, deg0 = tile_mm(x_local, h_local, me * m)
        (_, _, out, deg), _ = jax.lax.scan(
            body, (x_local, h_local, acc0, deg0), jnp.arange(1, p)
        )
    else:
        raise ValueError(f"unknown mode {mode!r}")

    if mean_pool:
        out = out / jnp.where(deg == 0, 1.0, deg)[:, None]
    return out


def khop_aggregate_sharded(
    x_local: jax.Array,
    features_local: jax.Array,
    comm_radius2,
    k_hops: int,
    axis_name: str = "ap",
    mode: str = "ring",
    mean_pool: bool = True,
) -> jax.Array:
    """[X, AX, A^2 X, ...] with the agent axis sharded — the
    ``ops.khop_aggregate`` input pipeline at swarm sizes past one device.

    DIFFERENTIABLE end to end: autodiff runs through the scan + ppermute
    ring, and each tile carries the swapped-operand custom VJP of
    ``ops.adjacency_matmul_block`` — so the
    sharded :class:`~gym_flock_tpu.models.LargeAggregationGNN` trains with
    the agent axis split over the mesh.  Call inside ``shard_map``.
    """
    zs = [features_local]
    z = features_local
    for _ in range(k_hops - 1):
        z = adjacency_matmul_sharded(
            x_local, z, comm_radius2, axis_name=axis_name, mode=mode,
            mean_pool=mean_pool,
        )
        zs.append(z)
    return jnp.concatenate(zs, axis=-1)


def flocking_step_sharded(
    x_local: jax.Array,
    params: FlockingParams,
    axis_name: str = "ap",
    mode: str = "ring",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One fused expert+dynamics+observation step on a sharded swarm.

    The sharded counterpart of the headline benchmark loop (bench.py):
    Turner expert -> Euler double-integrator -> 6-channel features -> reward,
    with ONE pairwise pass for the expert and one for the new observation.
    Returns ``(x_local', values_local [m, 6], reward)`` where reward — the
    reference's -sum of velocity variances (flocking_relative.py:145-147) —
    is computed from global psum'd moments and is identical on every shard.
    """
    u_local = turner_controller_sharded(x_local, params, axis_name, mode)
    x2 = _integrate(x_local, u_local, params.dt)
    values, _ = flocking_features_sharded(
        x2, params.comm_radius, params.comm_radius2, axis_name, mode
    )
    n = x_local.shape[0] * jax.lax.axis_size(axis_name)
    v = x2[:, 2:4]
    s1 = jax.lax.psum(jnp.sum(v, axis=0), axis_name)  # [2]
    s2 = jax.lax.psum(jnp.sum(v * v, axis=0), axis_name)  # [2]
    mean = s1 / n
    reward = -1.0 * jnp.sum(s2 / n - mean * mean)
    return x2, values, reward


def flocking_reset_sharded(
    key: jax.Array,
    params: FlockingParams,
    axis_name: str = "ap",
    mode: str = "ring",
) -> jax.Array:
    """Rejection-sampling reset with the acceptance test itself sharded.

    Semantics of reference flocking_relative.py:156-184 (redraw until global
    min degree >= 2 and min pairwise distance > threshold, here bounded at
    ``params.max_reset_tries``), but the O(N^2) degree/min-dist check runs
    as one sharded pairwise pass — no device ever sees the full swarm.  The
    draw uses per-shard folds of one key, so the same key yields the same
    swarm at any shard count.  Returns this shard's [m, 4] block.
    """
    n = params.n_agents
    p = jax.lax.axis_size(axis_name)
    me = jax.lax.axis_index(axis_name)
    if n % p != 0:
        raise ValueError(f"n_agents={n} must divide over axis size {p}")
    m = n // p

    def draw(key):
        kb, kf = jax.random.split(jax.random.fold_in(key, 0))
        bias = jax.random.uniform(kb, (2,), minval=-params.v_bias, maxval=params.v_bias)
        # one key per *global* agent, sliced to this shard's block — the
        # drawn swarm is a function of the key alone, not the shard count
        agent_keys = jax.lax.dynamic_slice_in_dim(
            jax.random.split(kf, n), me * m, m, axis=0
        )

        def per_agent(k):
            k1, k2, k3, k4 = jax.random.split(k, 4)
            length = jnp.sqrt(jax.random.uniform(k1, maxval=params.r_max_eff))
            angle = jnp.pi * jax.random.uniform(k2, maxval=2.0)
            vx = jax.random.uniform(k3, minval=-params.v_max, maxval=params.v_max)
            vy = jax.random.uniform(k4, minval=-params.v_max, maxval=params.v_max)
            return jnp.stack(
                (length * jnp.cos(angle), length * jnp.sin(angle),
                 vx + bias[0], vy + bias[1])
            )

        return jax.vmap(per_agent)(agent_keys)

    def accept(x_local):
        s = flocking_sums_sharded(
            x_local, params.comm_radius, params.comm_radius2, axis_name, mode
        )
        min_deg = jax.lax.pmin(jnp.min(s[:, 8]), axis_name)
        min_r2 = jax.lax.pmin(jnp.min(s[:, 9]), axis_name)
        return (min_deg >= 2) & (
            jnp.sqrt(min_r2) > params.min_dist_thresh
        )

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
    _, x, _, _ = jax.lax.while_loop(cond, body, (key0, x0, accept(x0), jnp.int32(1)))
    return x


def agent_sharded_rollout(
    params: FlockingParams,
    key: jax.Array,
    n_envs: int,
    n_steps: int,
    mesh: Optional[jax.sharding.Mesh] = None,
    mode: str = "ring",
):
    """Roll a batch of large swarms over a 2-D (env-batch x agent) mesh.

    Envs are sharded over ``dp`` and every swarm's agent axis over ``ap``
    (mesh from :func:`make_flock_mesh`); each step is one fused
    expert+dynamics+obs pass (:func:`flocking_step_sharded`).  Returns
    ``(x_final [n_envs, N, 4] sharded P("dp", "ap"), mean_reward scalar)``
    with the mean reward psum'd across the whole fleet — the only
    cross-``dp`` collective, at the learner boundary (SURVEY.md §5.8).
    """
    if mesh is None:
        mesh = make_flock_mesh(1, len(jax.devices()))
    dp_axis, ap_axis = mesh.axis_names
    n_dp = mesh.shape[dp_axis]
    if n_envs % n_dp != 0:
        raise ValueError(f"n_envs={n_envs} must divide over dp={n_dp}")

    from jax.sharding import PartitionSpec as P

    def local_fn(keys_local):
        def one_env(key):
            x0 = flocking_reset_sharded(key, params, ap_axis, mode)
            # cross-step fusion (same as the dense expert_rollout): the ring
            # pass at x_{t+1} produced for step t's observation carries its
            # expert channels into step t+1's controller — ONE ring schedule
            # per step instead of two
            chan = "core" if params.centralized else "full"
            s0 = flocking_sums_sharded(
                x0, params.comm_radius, params.comm_radius2, ap_axis, mode,
                channels=chan,
            )

            def body(carry, _):
                x, s = carry
                u = turner_controller_sharded(x, params, ap_axis, mode, sums=s)
                x2 = _integrate(x, u, params.dt)
                s2 = flocking_sums_sharded(
                    x2, params.comm_radius, params.comm_radius2, ap_axis,
                    mode, channels=chan,
                )
                n = x.shape[0] * jax.lax.axis_size(ap_axis)
                v = x2[:, 2:4]
                m1 = jax.lax.psum(jnp.sum(v, axis=0), ap_axis)
                m2 = jax.lax.psum(jnp.sum(v * v, axis=0), ap_axis)
                mean = m1 / n
                reward = -1.0 * jnp.sum(m2 / n - mean * mean)
                return (x2, s2), reward

            (x, _), rewards = jax.lax.scan(body, (x0, s0), None, length=n_steps)
            return x, jnp.mean(rewards)

        xs, mean_r = jax.vmap(one_env)(keys_local)
        # learner-boundary collective: fleet-wide mean reward
        mean_r = jax.lax.pmean(jnp.mean(mean_r), dp_axis)
        return xs, mean_r

    keys = jax.random.split(key, n_envs)
    shard_fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P(dp_axis),
        out_specs=(P(dp_axis, ap_axis), P()),
        check_vma=False,
    )
    return shard_fn(keys)
