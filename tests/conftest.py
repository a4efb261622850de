"""Test configuration: CPU backend with a virtual 8-device mesh and x64.

Multi-device sharding is validated on a virtual CPU mesh
(`--xla_force_host_platform_device_count=8`), the standard JAX trick for
testing `jax.sharding` layouts without several accelerators (SURVEY.md
§4).  x64 is enabled so exact-oracle comparisons (Kalman vs PF) are
meaningful.

`chip_smoke.py` runs the ``gpu``-marked tests inside its own process on
the card; it sets ``SGMCMC_TESTS_ON_DEVICE=1`` so this file leaves the
already-initialized GPU backend (and f32 defaults) alone.
"""
import os

ON_DEVICE = os.environ.get("SGMCMC_TESTS_ON_DEVICE") == "1"
if not ON_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules.

    The XLA CPU backend segfaults inside `backend_compile_and_load` when a
    single process accumulates the whole suite's compilations (reproduced
    twice at ~95% of the full run, in different tests; any subset passes).
    Clearing per module keeps within-module jit reuse (where all the reuse
    is) while bounding per-process compiler state.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Let the dispatch (`ops/dispatch.py`) route to the window kernel on
    the CPU, run in the Pallas interpreter — the only way a test reaches
    the kernel through the user-facing paths without a GPU."""
    from sgmcmc_tpu.ops import dispatch
    monkeypatch.setitem(dispatch.KERNEL_PLATFORMS, "cpu", True)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided here, at run time,
    never at import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on "
                    "the card")
    return jax.devices()[0]
