"""Joint resample-apply (`resampling.resample_apply`): its gather selects
exactly the ancestors of the one-hot matrix formulation
``P[i, j] = [c_{j-1} <= u_i < c_j]`` that the removed one-hot kernels
computed (kept here, test-side, as the reference)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgmcmc_tpu.ops import buffered
from sgmcmc_tpu.ops import resampling as rs


def _onehot_apply(pos, cdf, vals):
    """Dense one-hot reference: (shift(M) - M) @ vals with
    M[i, j] = [u_i >= c_j]."""
    M = (pos[:, None] >= cdf[None, :]).astype(vals.dtype)
    Mshift = jnp.concatenate([jnp.ones_like(M[:, :1]), M[:, :-1]], axis=1)
    return (Mshift - M) @ vals


def _positions(key, scheme, lw):
    return rs.resample_positions(scheme, key, lw.shape[0], lw.dtype)


def setup(seed=0, N=256, K=5):
    key = jax.random.PRNGKey(seed)
    lw = jax.random.normal(key, (N,), jnp.float64)
    vals = jax.random.normal(jax.random.fold_in(key, 1), (N, K),
                             jnp.float64) * 10
    return jax.random.fold_in(key, 2), lw, vals


def test_xla_equals_gather_exactly():
    key, lw, vals = setup()
    a = rs.resample_apply(key, lw, vals, "systematic")
    b = _onehot_apply(_positions(key, "systematic", lw), rs.weights_cdf(lw),
                      vals)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("scheme", ["multinomial", "systematic", "stratified"])
def test_modes_agree_all_schemes(scheme):
    key = jax.random.PRNGKey(3)
    N = 128
    lw = jax.random.normal(key, (N,), jnp.float64)
    vals = jax.random.normal(jax.random.fold_in(key, 1), (N, 3), jnp.float64)
    a = rs.resample_apply(key, lw, vals, scheme)
    b = _onehot_apply(_positions(key, scheme, lw), rs.weights_cdf(lw), vals)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("N,K", [(64, 3), (128, 7), (256, 5), (1024, 4)])
def test_xla2_selection_matches_gather_exactly(N, K):
    """f32 weights at the kernel's widths: the gather picks the same
    ancestor index as the one-hot compare for every particle."""
    key = jax.random.PRNGKey(11)
    lw = jax.random.normal(key, (N,), jnp.float32) * 2
    tags = jnp.broadcast_to(jnp.arange(N, dtype=jnp.float32)[:, None], (N, K))
    a = rs.resample_apply(jax.random.fold_in(key, 2), lw, tags, "systematic")
    b = _onehot_apply(_positions(jax.random.fold_in(key, 2), "systematic", lw),
                      rs.weights_cdf(lw), tags)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_xla2_values_close_to_gather():
    """Resampled f32 values are exact row copies (the one-hot product with
    a single unit entry per row reproduces them)."""
    key = jax.random.PRNGKey(12)
    N, K = 256, 5
    lw = jax.random.normal(key, (N,), jnp.float32)
    vals = jax.random.normal(jax.random.fold_in(key, 1), (N, K),
                             jnp.float32) * 10
    k2 = jax.random.fold_in(key, 2)
    a = rs.resample_apply(k2, lw, vals, "stratified")
    b = _onehot_apply(_positions(k2, "stratified", lw), rs.weights_cdf(lw),
                      vals)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_weights_cdf_degenerate_falls_back_to_uniform():
    lw = jnp.full((8,), -jnp.inf)
    np.testing.assert_allclose(np.asarray(rs.weights_cdf(lw)),
                               np.arange(1, 9) / 8.0)


def test_resample_positions_rejects_unknown_scheme():
    with pytest.raises(ValueError, match="scheme"):
        rs.resample_positions("residual", jax.random.PRNGKey(0), 4,
                              jnp.float32)


def test_resampled_rows_are_original_rows():
    """Every output row must be an exact copy of some input row."""
    key, lw, vals = setup(seed=4)
    out = np.asarray(rs.resample_apply(key, lw, vals, "systematic"))
    vset = {tuple(r) for r in np.asarray(vals)}
    for r in out:
        assert tuple(r) in vset


def test_resampling_counts_proportional_to_weights():
    """Mean selection frequency under systematic resample-apply matches
    the weights."""
    N = 64
    key = jax.random.PRNGKey(5)
    lw = jnp.log(jnp.arange(1, N + 1, dtype=jnp.float64))
    probs = np.exp(np.asarray(lw) - np.max(np.asarray(lw)))
    probs /= probs.sum()
    # tag rows by their index to track selections
    vals = jnp.arange(N, dtype=jnp.float64)[:, None]
    counts = np.zeros(N)
    reps = 300
    for i in range(reps):
        out = np.asarray(rs.resample_apply(
            jax.random.fold_in(key, i), lw, vals, "systematic"))
        idx = out[:, 0].astype(int)
        counts += np.bincount(idx, minlength=N)
    np.testing.assert_allclose(counts / (reps * N), probs, atol=0.002)


def _svm_pf(mode):
    from sgmcmc_tpu.models import svm
    params = svm.from_scalars(A=0.9, Q=0.5, R=1.0, dtype=jnp.float64)
    ys, _ = svm.generate_data(jax.random.PRNGKey(0), params, 25)
    return buffered.run_buffered_pf(
        svm.KERNEL, svm.grad_statistic, params, ys,
        key=jax.random.PRNGKey(7), n_particles=64, statistic_dim=3,
        smoother="poyiadjis_N", resampler="systematic",
        resample_mode=mode, prior_mean=0.0,
        prior_var=float(svm.stationary_variance(params)))


def test_pf_gather_vs_xla_mode_agree_in_pipeline():
    """Full buffered PF with the joint resample-apply ('auto') must equal
    index resampling ('gather'): same keys -> same positions -> same
    ancestors."""
    outs = {mode: _svm_pf(mode) for mode in ["gather", "auto"]}
    np.testing.assert_allclose(np.asarray(outs["gather"].mean_statistic),
                               np.asarray(outs["auto"].mean_statistic),
                               rtol=1e-9)
    np.testing.assert_allclose(float(outs["gather"].loglikelihood),
                               float(outs["auto"].loglikelihood), rtol=1e-9)


@pytest.mark.parametrize("mode", ["pallas", "pallas2", "xla", "xla2",
                                  "fused"])
def test_run_buffered_pf_rejects_kernel_modes(mode):
    with pytest.raises(ValueError, match="resample_mode"):
        _svm_pf(mode)
