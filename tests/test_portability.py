"""What the package needs from its installation and its machine: no flax, no
TPU-only Pallas module, caches inside the checkout, and a distributed
initialize that never hides a failed cluster launch."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent / "gym_flock_tpu"


def test_package_runs_without_flax():
    """A fresh interpreter in which ``import flax`` fails still imports the
    package and makes, resets and steps an env."""
    code = (
        "import sys; sys.modules['flax'] = None\n"
        "import jax, gym_flock_tpu as gft\n"
        "env, p = gft.make('FlockingRelative-v0', n_agents=8)\n"
        "s, o = env.reset(jax.random.key(0), p)\n"
        "s, o, r, d, i = env.step(jax.random.key(1), s, env.expert(s, p), p)\n"
        "from gym_flock_tpu.models import AggregationGNN\n"
        "print('ok', float(r))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        cwd=PKG.parent,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_no_module_imports_tpu_pallas_or_flax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 30
    bad = [
        (str(f.relative_to(PKG)), m)
        for f in files
        for m in _imported_modules(f)
        if m.startswith("jax.experimental.pallas.tpu") or m.split(".")[0] == "flax"
    ]
    assert not bad, bad


@pytest.mark.parametrize("env_value", [None, "/some/where/jax_cache"])
def test_compile_cache_dir_follows_env_or_checkout(monkeypatch, env_value):
    from gym_flock_tpu.utils import cache

    if env_value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache.compile_cache_dir() == str(PKG.parent / ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_value)
        assert cache.compile_cache_dir() == env_value
    monkeypatch.delenv("GYM_FLOCK_TPU_CACHE", raising=False)
    assert cache.bank_cache_dir() == PKG.parent / ".bank_cache"


def test_distributed_initialize_noop_alone_and_raises_in_a_cluster(monkeypatch):
    import jax

    from gym_flock_tpu.parallel import distributed

    calls = []

    def fake_initialize(**kw):
        calls.append(kw)
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", fake_initialize)
    for var in distributed._CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()  # single process: nothing to join
    assert calls == []

    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(RuntimeError, match="unreachable"):
        distributed.initialize()
    with pytest.raises(RuntimeError, match="unreachable"):
        distributed.initialize("localhost:1", num_processes=2, process_id=0)
    assert len(calls) == 2
