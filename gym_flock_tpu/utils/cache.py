"""Where the program keeps what it caches on disk: inside its checkout.

* JAX's persistent compile cache: ``$JAX_COMPILATION_CACHE_DIR`` when set,
  otherwise the fixed ``<checkout>/.jax_cache``.  A fixed path matters:
  the directory is part of the cache key, so one that moves never hits.
* Built graph banks: ``$GYM_FLOCK_TPU_CACHE`` when set, otherwise
  ``<checkout>/.bank_cache``.

Both defaults are listed in ``.gitignore``.
"""
from __future__ import annotations

import os
from pathlib import Path

__all__ = ["CHECKOUT", "compile_cache_dir", "enable_compile_cache", "bank_cache_dir"]

CHECKOUT = Path(__file__).resolve().parents[2]


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.

    Exports the directory in the environment, so subprocesses share it,
    and updates the live config, so it works after ``import jax`` too (as
    long as nothing has compiled yet).  Returns the directory."""
    path = compile_cache_dir()
    os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs",
        float(os.environ["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"]),
    )
    return path


def bank_cache_dir() -> Path:
    return Path(os.environ.get("GYM_FLOCK_TPU_CACHE") or CHECKOUT / ".bank_cache")
