"""Fused window kernel vs the unfused buffered PF (gather mode).

The fused path consumes randomness as (x0 normals, per-step proposal
normals, per-step systematic offsets).  Reconstructing exactly the draws
the unfused gather path makes lets us compare trajectories deterministically
at small N (same selections; values differ only by f32 summation order).
The kernel runs in the Pallas interpreter here; `test_gpu.py` runs it
compiled on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgmcmc_tpu.models import svm
from sgmcmc_tpu.ops import buffered
from sgmcmc_tpu.ops.pallas.fused_pf import (fused_pf_score,
                                            fused_window_batched,
                                            supports_particles)


def _gather_path_draws(key, N, W, prior_mean, prior_var):
    """Replicate run_buffered_pf's PRNG consumption in the kernel layout:
    x0 [1, D=1, N], normals [1, W, Z=1, N], offsets [1, W]."""
    key_init, key_steps = jax.random.split(key)
    z0 = jax.random.normal(key_init, (N, 1), jnp.float32)
    x0 = prior_mean + jnp.sqrt(prior_var) * z0
    step_keys = jax.random.split(key_steps, W)
    xis, zs = [], []
    for t in range(W):
        kr, kp = jax.random.split(step_keys[t])
        xis.append(jax.random.uniform(kr, (), jnp.float32))
        zs.append(jax.random.normal(kp, (N, 1), jnp.float32)[:, 0])
    return (x0[:, 0][None, None], jnp.stack(zs)[None, :, None, :],
            jnp.stack(xis)[None])


@pytest.mark.parametrize("seed", [0, 3])
def test_fused_matches_gather_deterministically(seed):
    params = svm.from_scalars(A=0.9, Q=0.5, R=1.0, dtype=jnp.float32)
    T, N = 24, 64
    ys, _ = svm.generate_data(jax.random.PRNGKey(1), params, T)
    ys = ys.astype(jnp.float32)
    pv = float(svm.stationary_variance(params))
    key = jax.random.PRNGKey(seed)

    ref = buffered.run_buffered_pf(
        svm.KERNEL, svm.grad_statistic, params, ys, key=key,
        n_particles=N, statistic_dim=3, smoother="poyiadjis_N",
        resampler="systematic", resample_mode="gather",
        prior_mean=0.0, prior_var=pv)

    x0, normals, xi = _gather_path_draws(key, N, T, 0.0, pv)
    pvec = svm._fused_pack(params).astype(jnp.float32).reshape(1, -1)
    w = jnp.ones((1, T), jnp.float32)
    ms, ll = fused_window_batched(
        svm.FUSED, pvec, x0, normals, ys[None, :, 0], w, xi,
        interpret=True)
    np.testing.assert_allclose(np.asarray(ms[0]),
                               np.asarray(ref.mean_statistic),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(float(ll[0]), float(ref.loglikelihood),
                               rtol=1e-4)


def test_fused_statistically_matches_gather():
    """Score estimator means agree within Monte-Carlo error."""
    params = svm.from_scalars(A=0.9, Q=0.5, R=1.0, dtype=jnp.float32)
    T, N, R = 20, 64, 60
    ys, _ = svm.generate_data(jax.random.PRNGKey(0), params, T)
    ys = ys.astype(jnp.float32)
    w = jnp.ones((T,), jnp.float32)
    pv = float(svm.stationary_variance(params))

    gather = jax.jit(lambda k: buffered.run_buffered_pf(
        svm.KERNEL, svm.grad_statistic, params, ys, key=k, n_particles=N,
        statistic_dim=3, smoother="poyiadjis_N", resampler="systematic",
        resample_mode="gather", prior_mean=0.0, prior_var=pv))
    g = np.stack([np.asarray(gather(jax.random.fold_in(
        jax.random.PRNGKey(10), i)).mean_statistic) for i in range(R)])

    f = np.stack([np.asarray(fused_pf_score(
        svm.FUSED, jax.random.fold_in(jax.random.PRNGKey(20), i), params,
        ys, w, N, 0.0, pv, interpret=True)[0]) for i in range(R)])

    se = np.sqrt(g.std(0) ** 2 + f.std(0) ** 2) / np.sqrt(R)
    assert np.all(np.abs(g.mean(0) - f.mean(0)) < 4 * se + 1e-3), \
        (g.mean(0), f.mean(0), se)


def test_fused_vmap_collapses_to_batch():
    """vmap over chains must give the same numbers as the direct batch."""
    params = svm.from_scalars(A=0.8, Q=0.7, R=1.2, dtype=jnp.float32)
    T, N, C = 12, 32, 4
    ys, _ = svm.generate_data(jax.random.PRNGKey(2), params, T)
    ys = ys.astype(jnp.float32)
    w = jnp.ones((T,), jnp.float32)
    pv = float(svm.stationary_variance(params))
    keys = jax.random.split(jax.random.PRNGKey(5), C)

    ms_v, ll_v = jax.vmap(lambda k: fused_pf_score(
        svm.FUSED, k, params, ys, w, N, 0.0, pv, interpret=True))(keys)
    ms_s = jnp.stack([fused_pf_score(svm.FUSED, k, params, ys, w, N,
                                     0.0, pv, interpret=True)[0]
                      for k in keys])
    np.testing.assert_allclose(np.asarray(ms_v), np.asarray(ms_s),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel_name", ["optimal", "prior"])
def test_garch_fused_statistically_matches_gather(kernel_name):
    """GARCH (2-D particle state, deterministic sigma^2 carry) fused vs
    unfused score means within Monte-Carlo error."""
    from sgmcmc_tpu.models import garch
    params = garch.from_alpha_beta_gamma(0.1, 0.6, 0.2, R=0.5,
                                         dtype=jnp.float32)
    T, N, R = 20, 64, 60
    ys, _ = garch.generate_data(jax.random.PRNGKey(0), params, T)
    ys = ys.astype(jnp.float32)
    w = jnp.ones((T,), jnp.float32)
    pv = float(garch.stationary_variance(params))

    kern = garch.get_kernel(kernel_name)
    fused = garch.get_fused(kernel_name)
    gather = jax.jit(lambda k: buffered.run_buffered_pf(
        kern, garch.grad_statistic, params, ys, key=k, n_particles=N,
        statistic_dim=4, smoother="poyiadjis_N", resampler="systematic",
        resample_mode="gather", prior_mean=0.0, prior_var=pv))
    g = np.stack([np.asarray(gather(jax.random.fold_in(
        jax.random.PRNGKey(10), i)).mean_statistic) for i in range(R)])

    f = np.stack([np.asarray(fused_pf_score(
        fused, jax.random.fold_in(jax.random.PRNGKey(20), i), params,
        ys, w, N, 0.0, pv, interpret=True)[0]) for i in range(R)])

    se = np.sqrt(g.std(0) ** 2 + f.std(0) ** 2) / np.sqrt(R)
    assert np.all(np.abs(g.mean(0) - f.mean(0)) < 4 * se + 1e-3), \
        (g.mean(0), f.mean(0), se)


@pytest.mark.parametrize("kernel_name", ["optimal", "prior"])
def test_lgssm_fused_matches_exact_kalman_gradient(kernel_name):
    """Fused PF score on the full window -> exact marginal gradient
    (the Kalman oracle, the reference's own correctness anchor:
    `gradient_error_fig_scripts/lgssm_grad_compare.py:59-79`)."""
    from sgmcmc_tpu.models import lgssm
    params = lgssm.from_matrices(A=[[0.8]], C=[[1.0]], Q=[[0.5]],
                                 R=[[1.0]], dtype=jnp.float64)
    T, N, R = 16, 256, 80
    ys, _ = lgssm.generate_data(jax.random.PRNGKey(0), params, T)
    exact = lgssm.gradient_marginal_loglikelihood(params, ys)
    exact_vec = np.array([
        float(exact.LRinv_vec[0]), float(exact.LQinv_vec[0]),
        float(exact.C[0, 0]), float(exact.A[0, 0])])

    p32 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                 params)
    w = jnp.ones((T,), jnp.float32)
    fused = lgssm.get_fused(kernel_name)
    f = np.stack([np.asarray(fused_pf_score(
        fused, jax.random.fold_in(jax.random.PRNGKey(5), i), p32,
        ys.astype(jnp.float32), w, N, 0.0, 10.0, interpret=True)[0])
        for i in range(R)])
    se = f.std(0) / np.sqrt(R)
    z = (f.mean(0) - exact_vec) / (se + 1e-9)
    assert np.all(np.abs(z) < 5), (f.mean(0), exact_vec, se, z)


def test_fused_score_fn_integration(interpret_kernels):
    """make_pf_score_fn(resample_mode='fused') drives an SGLD chain."""
    from sgmcmc_tpu.inference import sgmcmc
    T = 60
    true = svm.from_scalars(A=0.9, Q=0.5, R=1.0, dtype=jnp.float32)
    ys, _ = svm.generate_data(jax.random.PRNGKey(0), true, T)
    ys = ys.astype(jnp.float32)
    cfg = sgmcmc.PFScoreConfig(
        n_particles=32, subsequence_length=16, buffer_length=4,
        minibatch_size=1, smoother="poyiadjis_N", resampler="systematic",
        resample_mode="fused")
    score = sgmcmc.make_pf_score_fn(
        svm.KERNEL, svm.grad_statistic, 3, svm.unpack_grad, cfg, T,
        prior_mean_var_fn=lambda p: (0.0, svm.stationary_variance(p)),
        fused_model=svm.FUSED)
    grad, ll = score(jax.random.PRNGKey(3), true, ys)
    assert np.isfinite(float(ll))
    for leaf in jax.tree_util.tree_leaves(grad):
        assert np.all(np.isfinite(np.asarray(leaf)))


def test_sampler_api_reaches_fused_kernel(interpret_kernels, monkeypatch):
    """The high-level Sampler API reaches the window kernel through the
    dispatch ('auto' on a platform with the kernel), forwarding the
    config's smoother lambda and ESS threshold."""
    from sgmcmc_tpu.inference import sgmcmc
    from sgmcmc_tpu.inference.samplers import SVMSampler

    captured = {}
    orig = sgmcmc.fused_pf_score

    def spy(*args, **kw):
        captured.update(kw)
        return orig(*args, **kw)

    monkeypatch.setattr(sgmcmc, "fused_pf_score", spy)
    true = svm.from_scalars(A=0.9, Q=0.5, R=1.0, dtype=jnp.float64)
    ys, _ = svm.generate_data(jax.random.PRNGKey(0), true, 64)
    s = SVMSampler(observations=ys, parameters=true, seed=9)
    grad = s.noisy_gradient(N=32, subsequence_length=8, buffer_length=2,
                            pf="nemeth", lambduh=0.9, ess_threshold=0.5,
                            resampler="systematic", resample_mode="auto")
    assert captured["lambduh"] == 0.9 and captured["ess_threshold"] == 0.5
    assert captured["interpret"] is True
    for leaf in jax.tree_util.tree_leaves(grad):
        assert np.all(np.isfinite(np.asarray(leaf)))


@pytest.mark.parametrize("option", ["rng", "qp_merge", "pipeline",
                                    "interleave", "gather"])
def test_sampler_rejects_removed_kernel_options(option):
    """Options of the removed earlier kernel raise instead of being ignored."""
    from sgmcmc_tpu.inference.samplers import SVMSampler
    true = svm.from_scalars(A=0.9, Q=0.5, R=1.0, dtype=jnp.float64)
    ys, _ = svm.generate_data(jax.random.PRNGKey(0), true, 32)
    s = SVMSampler(observations=ys, parameters=true, seed=9)
    with pytest.raises(ValueError, match="removed"):
        s.noisy_gradient(N=32, subsequence_length=8, buffer_length=2,
                         **{option: 1})


@pytest.mark.parametrize("n, ok", [(16, True), (1024, True), (8, False),
                                   (1000, False), (96, False)])
def test_supports_particles_power_of_two(n, ok):
    assert supports_particles(n) is ok


def test_window_kernel_rejects_unsupported_particle_count():
    C, W, N = 1, 4, 24
    with pytest.raises(ValueError, match="power-of-two"):
        fused_window_batched(
            svm.FUSED, jnp.ones((C, 3)), jnp.zeros((C, 1, N)),
            jnp.zeros((C, W, 1, N)), jnp.zeros((C, W)), jnp.ones((C, W)),
            jnp.zeros((C, W)), interpret=True)


def test_window_kernel_lowers_for_gpu():
    """The kernel traces through the Pallas Triton lowering at the
    flagship width (N=1024, W=60): every primitive it uses has a GPU
    lowering rule.  (Compiling and running it needs the card.)"""
    C, W, N = 2, 60, 1024
    args = (jnp.ones((C, 3), jnp.float32), jnp.zeros((C, 1, N), jnp.float32),
            jnp.zeros((C, W, 1, N), jnp.float32),
            jnp.zeros((C, W), jnp.float32), jnp.ones((C, W), jnp.float32),
            jnp.zeros((C, W), jnp.float32))
    f = jax.jit(lambda *a: fused_window_batched(svm.FUSED, *a,
                                                ess_threshold=0.5))
    text = f.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "fused_pf_window" in text
