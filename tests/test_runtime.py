"""Process set-up (`utils/runtime.py`) and what the sampling path imports."""
import os
import pathlib
import subprocess
import sys

import jax

from sgmcmc_tpu.utils import runtime

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_compile_cache_defaults_to_fixed_repo_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        got = runtime.enable_compile_cache()
        assert got == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert runtime.enable_compile_cache() == got       # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_respects_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", old)
        assert runtime.enable_compile_cache() == str(tmp_path)
        # nothing set in code: the config is whatever JAX read itself
        assert jax.config.jax_compilation_cache_dir == old
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_is_gitignored():
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


_BLOCKED = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("flax", "pandas", "matplotlib"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import jax, jax.numpy as jnp
import sgmcmc_tpu.inference.samplers, sgmcmc_tpu.models.svm
from sgmcmc_tpu.inference.samplers import SVMSampler
from sgmcmc_tpu.models import svm
ys, _ = svm.generate_data(jax.random.PRNGKey(0), svm.from_scalars(0.9, 0.5, 1.0), 64)
s = SVMSampler(observations=ys, parameters=svm.from_scalars(0.5, 1.0, 2.0))
s.fit_scan("SGLD", num_iters=2, num_chains=2, N=16, subsequence_length=8,
           buffer_length=2, record="none")
print("ok")
"""


def test_sampling_path_imports_without_flax_pandas_matplotlib():
    r = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
