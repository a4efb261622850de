"""Tests that need the card: the window kernel compiled for the GPU and
float32 numerics on the device.  They carry the ``gpu`` marker and skip
elsewhere; `python chip_smoke.py` runs them on the card (phase 5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgmcmc_tpu.models import svm
from sgmcmc_tpu.ops import dispatch
from sgmcmc_tpu.ops.pallas.fused_pf import fused_window_batched

pytestmark = pytest.mark.gpu


def _window_args(N, W, C=8, seed=0):
    k = jax.random.split(jax.random.PRNGKey(seed), 5)
    pvec = jnp.broadcast_to(svm._fused_pack(svm.from_scalars(
        A=0.9, Q=0.5, R=1.0)).astype(jnp.float32).reshape(1, -1), (C, 3))
    return (pvec, jax.random.normal(k[0], (C, 1, N), jnp.float32),
            jax.random.normal(k[1], (C, W, 1, N), jnp.float32),
            jax.random.normal(k[2], (C, W), jnp.float32),
            jnp.ones((C, W), jnp.float32),
            jax.random.uniform(k[3], (C, W), jnp.float32))


def test_dispatch_routes_auto_to_compiled_kernel(gpu):
    assert dispatch.pf_path("auto", True) == dispatch.PFPath(True, False)
    assert dispatch.pf_path("fused", True).interpret is False
    assert dispatch.pf_path("auto", False).fused is False


@pytest.mark.parametrize("N, W", [(64, 60), (1024, 2)])
def test_window_kernel_compiled_matches_interpreter(gpu, N, W):
    """Compiled Triton kernel vs the Pallas interpreter on the same card
    and inputs.  N=64 over a full window and N=1024 over two steps stay
    clear of CDF-rounding ancestor flips: rtol 1e-4 (f32 reassociation)."""
    args = _window_args(N, W)
    a = fused_window_batched(svm.FUSED, *args)
    b = fused_window_batched(svm.FUSED, *args, interpret=True)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=1e-4, atol=1e-4)


def test_window_kernel_options_compile_and_match(gpu):
    """Nemeth shrinkage, the ESS gate and the validity gate compile for
    the card and match the interpreter."""
    N, W = 64, 20
    args = _window_args(N, W)
    vs = jnp.concatenate([jnp.ones((8, 15)), jnp.zeros((8, 5))], axis=1)
    kw = dict(lambduh=0.95, ess_threshold=0.5, vs=vs, valid_gate=True)
    a = fused_window_batched(svm.FUSED, *args, **kw)
    b = fused_window_batched(svm.FUSED, *args, interpret=True, **kw)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=1e-4, atol=1e-4)


def test_kalman_gradient_f32_on_device_matches_f64_host(gpu):
    """The exact Kalman gradient in float32 on the card, at 'highest'
    matmul precision, agrees with the float64 host value to 1e-4 relative
    (TF32 products would be off by ~1e-3)."""
    from sgmcmc_tpu.models import lgssm
    mats = dict(A=[[0.8]], C=[[1.0]], Q=[[0.5]], R=[[1.0]])
    p32 = lgssm.from_matrices(**mats, dtype=jnp.float32)
    ys, _ = lgssm.generate_data(jax.random.PRNGKey(0), p32, 200)
    ys = np.asarray(ys)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), jax.enable_x64(True):
        ref = jax.tree_util.tree_leaves(lgssm.gradient_marginal_loglikelihood(
            lgssm.from_matrices(**mats, dtype=jnp.float64),
            jnp.asarray(ys, jnp.float64)))
    with jax.default_matmul_precision("highest"):
        got = jax.tree_util.tree_leaves(jax.jit(
            lgssm.gradient_marginal_loglikelihood)(p32, jnp.asarray(ys)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(r), rtol=1e-4, atol=1e-3)
