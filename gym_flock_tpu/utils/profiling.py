"""Profiling helpers (SURVEY.md §5.1: the reference has only driver-side
wall-clock timing; the rebuild pairs the JAX profiler with step-rate
measurement that waits for the device)."""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator

import jax
import jax.numpy as jnp

__all__ = ["trace", "measure_steps_per_second"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``jax.profiler.trace`` context; view with TensorBoard/XProf."""
    with jax.profiler.trace(log_dir):
        yield


def measure_steps_per_second(
    run: Callable[[jax.Array], jax.Array],
    n_steps_per_call: int,
    iters: int = 3,
    warmup: bool = True,
) -> float:
    """Time a jitted scalar-returning rollout fn; each call ends in a
    scalar fetch, which waits for the device.  ``run(key)`` must return a
    scalar that depends on every step."""
    if warmup:
        float(run(jax.random.key(0)))
    t0 = time.perf_counter()
    for i in range(iters):
        float(run(jax.random.key(i + 1)))
    dt = time.perf_counter() - t0
    return n_steps_per_call * iters / dt
