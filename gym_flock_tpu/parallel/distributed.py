"""Multi-host scale-out: initialization, meshes, and per-host RNG.

The reference is a single NumPy process with no distribution story
(SURVEY.md §2.3).  Here scale-out is pure JAX plumbing: because rollouts and
the DP train step are written against a ``Mesh`` (``rollout.py``,
``train.py``), running on several hosts requires only

    from gym_flock_tpu.parallel.distributed import initialize, global_env_mesh
    initialize("host0:1234", num_processes=2, process_id=0)
    mesh = global_env_mesh("env")      # every device on every host

and the same ``sharded_rollout`` / ``make_sharded_train_step`` calls.  Data
layout rules that keep collectives rare:

* the env-batch axis shards over *all* devices (envs are independent, so the
  per-step program has zero cross-device communication);
* model params/optimizer state are replicated; gradient ``pmean`` is the one
  all-reduce per step;
* host-side artifacts (graph banks, VRP labels) are broadcast once — banks
  are identical on every host by construction (same seed), so no transfer is
  needed; per-host RNG streams come from :func:`host_fold` folding the
  process index into the key.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np

__all__ = ["initialize", "global_env_mesh", "host_fold", "local_shard_size"]


# environment variables that announce a multi-process launch to
# ``jax.distributed.initialize`` (its own, SLURM's and Open MPI's)
_CLUSTER_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "JAX_NUM_PROCESSES",
    "SLURM_JOB_ID",
    "OMPI_COMM_WORLD_SIZE",
)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """``jax.distributed.initialize``, a no-op for a single process.

    With no arguments and none of the cluster variables above set, there is
    nothing to join and this returns (so the same program runs everywhere).
    Otherwise the arguments, or the cluster's variables, go to
    ``jax.distributed.initialize`` and any failure propagates: a launch
    that meant to be multi-process must not quietly run single-process.
    """
    import os

    explicit = (coordinator_address, num_processes, process_id)
    if all(a is None for a in explicit) and not any(
        os.environ.get(v) for v in _CLUSTER_VARS
    ):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_env_mesh(axis_name: str = "env") -> jax.sharding.Mesh:
    """1-D mesh over every device of every host (env-batch / dp axis)."""
    return jax.sharding.Mesh(np.asarray(jax.devices()), (axis_name,))


def host_fold(key: jax.Array) -> jax.Array:
    """Fold this host's process index into a PRNG key.

    Use for host-local randomness (e.g. host-side VRP label sampling);
    device-side keys should instead be split globally and sharded so results
    are independent of host count.
    """
    return jax.random.fold_in(key, jax.process_index())


def local_shard_size(n_global: int) -> int:
    """Rows of a globally sharded batch owned by this process."""
    n_proc = jax.process_count()
    assert n_global % n_proc == 0, (n_global, n_proc)
    return n_global // n_proc
