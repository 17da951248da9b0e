"""What the GPU entry points do where there is no GPU, and where they
keep the compile cache.  Each runs in a child process, as users run
them, so no JAX setting leaks into the other tests."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(args, cwd=REPO, **env):
    full = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO), **env}
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=cwd, env=full, timeout=300)


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_path(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and nothing overrides it; without
    it the cache sits at one fixed path inside the checkout."""
    env = {}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import jax; from t41x.utils import compile_cache; "
            "print(compile_cache.enable()); "
            "print(jax.config.jax_compilation_cache_dir)")
    r = _run(["-c", code], cwd=tmp_path, **env)
    assert r.returncode == 0, r.stderr[-2000:]
    returned, in_force = r.stdout.split()
    want = str(tmp_path / env_dir) if env_dir else str(REPO / ".jax_cache")
    assert returned == in_force == want


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On a CPU-only backend, and as a lone file outside the checkout,
    chip_smoke.py exits non-zero and prints no result line."""
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        r = _run(["chip_smoke.py"], cwd=tmp_path, PYTHONPATH="")
    else:
        r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu():
    """bench.py measures the GPU only: on the CPU it exits non-zero
    without a JSON line instead of timing the CPU."""
    r = _run(["bench.py", "--config", "rx", "--channels", "8"])
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"metric"' not in r.stdout
