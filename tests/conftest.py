"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Tests run on the CPU backend with 8 virtual devices, so sharding and
collectives are exercised for real without a multi-device machine
(SURVEY.md §7 step 7).  ``JAX_PLATFORMS`` defaults to ``cpu``; tests marked
``gpu`` need an NVIDIA card, decide so in the ``_gpu_only`` fixture, and
skip elsewhere.  On a machine with a card run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (``chip_smoke.py``
covers the same paths at full width).
"""
import os

# The suite is XLA-COMPILE-bound (tiny data, many distinct programs), so the
# test config trades codegen quality for compile time:
#   * backend optimization level 0 — ~20% faster compiles, measured; tests
#     assert correctness, not throughput (bench.py keeps full optimization);
#   * a persistent compile cache shared across xdist workers, subprocess
#     tests (the env var is inherited) and repeated runs
#     (gym_flock_tpu.utils.cache).
_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    _flags += " --xla_force_host_platform_device_count=8"
if "--xla_backend_optimization_level" not in _flags:
    _flags += " --xla_backend_optimization_level=0"
os.environ["XLA_FLAGS"] = _flags.strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Occupancy envs auto-discover the reference's real ARL facility map
# (envs/maps.py) — a 5,759-node ExploreFull world.  The suite defaults to
# the procedural worlds for speed and world-size stability; the dedicated
# real-map tests (test_real_map.py) re-enable discovery explicitly.
os.environ.setdefault("GYM_FLOCK_TPU_MAPS", "off")

import jax

from gym_flock_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is a GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs this path on the card)")


@pytest.fixture
def triton_adj_tile(monkeypatch):
    """Route the adjacency tile through the Triton kernel in interpret mode,
    so CPU tests exercise the kernel wherever the GPU would run it."""
    from gym_flock_tpu.ops import pallas_flocking as pf

    def tile(xr, xc, h, offs, comm_radius2):
        return pf._adj_matmul_triton(xr, xc, h, offs, comm_radius2, interpret=True)

    monkeypatch.setattr(pf, "_adj_tile", tile)
    return tile


@pytest.fixture(scope="session")
def devices8():
    devs = jax.devices()
    assert len(devs) >= 8, f"expected 8 virtual CPU devices, got {devs}"
    return devs


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="run tests marked slow (full-depth tier)",
    )


def pytest_collection_modifyitems(config, items):
    """Tier the suite: the default run stays under ~5 minutes (every
    component exercised at least once); full-depth variants are marked
    ``slow`` and run with --runslow / GFT_SLOW=1 / -m slow."""
    run_slow = (
        config.getoption("--runslow")
        or os.environ.get("GFT_SLOW", "") not in ("", "0")
        or "slow" in (config.getoption("-m") or "")
    )
    if run_slow:
        return
    skip = pytest.mark.skip(
        reason="slow tier: pass --runslow (or GFT_SLOW=1) to run"
    )
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
