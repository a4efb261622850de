"""`chip_smoke.py` phase functions at tiny size on the CPU (the device
check stubbed where a phase would need the card)."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def f32():
    """The smoke runs in float32, as on the card."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def test_require_gpu_refuses_cpu_and_empty():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.require_gpu([])


@pytest.mark.parametrize("script, marker", [("chip_smoke.py", '"ok"'),
                                            ("bench.py", '"value"')])
def test_script_exits_nonzero_without_gpu(script, marker):
    r = subprocess.run([sys.executable, os.path.join(REPO, script)],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert marker not in r.stdout


def test_phase_flagship_tiny(f32):
    out = chip_smoke.phase_flagship("cpu", n_chains=4, n_particles=32,
                                    T=200, subseq=16, buffer=4, iters=10)
    assert np.isfinite(out["steps_per_s"]) and out["A_end"] > 0.5


def test_phase_kernel_vs_reference_tiny(f32):
    out = chip_smoke.phase_kernel_vs_reference(n_chains=8, n_particles=64,
                                               W=12, interpret=True)
    assert out["w1_agree"] == 1.0


def test_phase_kalman_oracle_tiny(f32):
    out = chip_smoke.phase_kalman_oracle(n_particles=256, reps=64, T=16,
                                         modes=("gather",))
    assert set(out) == {"gather"}


def test_phase_chain_sharded_tiny(f32):
    out = chip_smoke.phase_chain_sharded(jax.devices()[:4], n_chains=8,
                                         n_particles=32, T=100, subseq=8,
                                         buffer=2, iters=2)
    assert out["max_rel_diff"] < 1e-5


def test_phase_particle_sharded_tiny(f32):
    out = chip_smoke.phase_particle_sharded(jax.devices()[:4],
                                            n_particles=256, T=20, reps=8)
    assert max(out["z"]) < 5
