"""Process set-up: the compile cache, the GPU check, and the refusals of
bench.py and chip_smoke.py on a machine without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from gym_anm_tpu import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the variable itself


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = runtime.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache") == jax.config.jax_compilation_cache_dir
        assert runtime.enable_compile_cache() == path  # no temp name, pid or time in it
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_require_gpu(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert runtime.require_gpu()["platform"] == "cpu"  # a rehearsal the caller asked for
    monkeypatch.delenv("JAX_PLATFORMS")
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


def test_card_identity_without_nvidia_smi(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", missing)
    assert runtime.card_identity() == "not available"


def _no_gpu_env():
    if shutil.which("nvidia-smi"):
        pytest.skip("a GPU machine would run the script for real")
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = ROOT
    return env


@pytest.mark.parametrize("script", [["chip_smoke.py"], ["chip_smoke.py", "--four-cards"], ["bench.py", "--batch", "8"]])
def test_scripts_refuse_without_gpu(script):
    r = subprocess.run([sys.executable, *script], cwd=ROOT, env=_no_gpu_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = _no_gpu_env()
    env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
