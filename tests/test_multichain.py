"""Multi-chain `fit_scan(num_chains=C)`: the first-class vmapped-chain
surface (accelerator form of the reference's shell-job-per-chain
parallelism, `driver_utils.py:79`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgmcmc_tpu.inference.samplers import LGSSMSampler, SVMSampler
from sgmcmc_tpu.models import svm as svm_mod

KW = dict(N=16, subsequence_length=16, buffer_length=2)


@pytest.fixture(scope="module")
def svm_obs():
    true = svm_mod.from_scalars(A=0.9, Q=0.5, R=1.0, dtype=jnp.float64)
    ys, _ = svm_mod.generate_data(jax.random.PRNGKey(0), true, 100)
    return ys


def _sampler(svm_obs, seed=1):
    s = SVMSampler(observations=svm_obs, seed=seed)
    s.parameters = svm_mod.from_scalars(A=0.5, Q=1.0, R=2.0,
                                        dtype=jnp.float64)
    return s


def test_multichain_trace_shape_and_divergence(svm_obs):
    s = _sampler(svm_obs)
    trace = s.fit_scan("SGLD", num_iters=4, epsilon=0.05, num_chains=3,
                       **KW)
    assert trace.A.shape == (3, 4, 1, 1)
    # independent noise keys: chains diverge from the shared init
    final = np.asarray(trace.A[:, -1, 0, 0])
    assert len(np.unique(final)) == 3
    # sampler now holds the stacked chains
    assert s.parameters.A.shape == (3, 1, 1)
    assert s._num_chains == 3


def test_multichain_continuation_and_select(svm_obs):
    s = _sampler(svm_obs)
    t1 = s.fit_scan("SGLD", num_iters=2, epsilon=0.05, num_chains=2, **KW)
    stacked = np.asarray(s.parameters.A)
    t2 = s.fit_scan("SGLD", num_iters=2, epsilon=0.05, num_chains=2, **KW)
    # second call continued the stacked state, not a re-broadcast
    assert t2.A.shape == (2, 2, 1, 1)
    assert not np.allclose(np.asarray(t2.A[:, 0]), stacked[:, None][: , 0])
    p = s.select_chain(1)
    assert p.A.shape == (1, 1)
    assert s._num_chains is None
    # mismatched re-fit without select_chain raises
    s2 = _sampler(svm_obs)
    s2.fit_scan("SGLD", num_iters=1, epsilon=0.05, num_chains=2, **KW)
    with pytest.raises(ValueError, match="stacked chains"):
        s2.fit_scan("SGLD", num_iters=1, epsilon=0.05, num_chains=3, **KW)


def test_multichain_prior_init_distinct(svm_obs):
    s = _sampler(svm_obs)
    s.fit_scan("SGLD", num_iters=1, epsilon=0.01, num_chains=4,
               chain_init="prior", **KW)
    a0 = np.asarray(s.parameters.A[:, 0, 0])
    assert len(np.unique(a0)) == 4
    assert s.parameters.A.dtype == jnp.float64


def test_multichain_explicit_init_pytree(svm_obs):
    s = _sampler(svm_obs)
    inits = jax.tree_util.tree_map(
        lambda x: jnp.stack([x, x + 0.01]), s.parameters)
    trace = s.fit_scan("SGLD", num_iters=2, epsilon=0.0, num_chains=2,
                       chain_init=inits, **KW)
    assert trace.A.shape == (2, 2, 1, 1)
    with pytest.raises(ValueError, match="leading axis"):
        s2 = _sampler(svm_obs)
        s2.fit_scan("SGLD", num_iters=1, num_chains=3, chain_init=inits,
                    **KW)


def test_record_thinning_and_none(svm_obs):
    s = _sampler(svm_obs)
    trace = s.fit_scan("SGLD", num_iters=6, epsilon=0.05, num_chains=2,
                       record=3, **KW)
    assert trace.A.shape == (2, 2, 1, 1)
    trace, aux = s.fit_scan("SGLD", num_iters=4, epsilon=0.05,
                            num_chains=2, record="none", return_aux=True,
                            **KW)
    assert trace is None
    assert aux.shape == (2, 4)
    # non-dividing record truncates with a warning (VERDICT r5 #6)
    with pytest.warns(UserWarning, match="does not divide"):
        trace = s.fit_scan("SGLD", num_iters=5, num_chains=2, record=3,
                           **KW)
    assert trace.A.shape == (2, 1, 1, 1)


def test_record_thinning_single_chain(svm_obs):
    s = _sampler(svm_obs)
    trace = s.fit_scan("SGLD", num_iters=6, epsilon=0.05, record=2, **KW)
    assert trace.A.shape == (3, 1, 1)


def test_fit_scan_chunked_multichain(svm_obs):
    s = _sampler(svm_obs)
    trace = s.fit_scan_chunked("SGLD", num_iters=6, chunk_iters=2,
                               epsilon=0.05, num_chains=2, **KW)
    assert isinstance(trace.A, np.ndarray)
    assert trace.A.shape == (2, 6, 1, 1)
    trace = s.select_chain(0)


def test_multichain_adagrad(svm_obs):
    s = _sampler(svm_obs)
    trace = s.fit_scan("ADAGRAD", num_iters=3, epsilon=0.05, num_chains=2,
                       **KW)
    assert trace.A.shape == (2, 3, 1, 1)
    # moment state is stacked per chain and carried across calls
    lead = jax.tree_util.tree_leaves(s._adagrad_state)[0]
    assert lead.shape[0] == 2
    s.fit_scan("ADAGRAD", num_iters=2, epsilon=0.05, num_chains=2, **KW)


def test_multichain_marginal_kind_lgssm():
    from sgmcmc_tpu.models import lgssm as lgssm_mod
    true = lgssm_mod.from_matrices(A=[[0.9]], C=[[1.0]], Q=[[0.5]],
                                   R=[[1.0]], dtype=jnp.float64)
    ys, _ = lgssm_mod.generate_data(jax.random.PRNGKey(2), true, 80)
    s = LGSSMSampler(observations=ys, seed=3)
    trace = s.fit_scan("SGLD", num_iters=3, epsilon=0.05, num_chains=2,
                       kind="marginal", subsequence_length=16,
                       buffer_length=2)
    assert trace.A.shape == (2, 3, 1, 1)
    assert np.all(np.isfinite(np.asarray(trace.A)))


def test_multichain_pooled_posterior_statistics(svm_obs):
    """End-to-end: pooled multi-chain trace feeds the convergence
    diagnostics (the reference_comparison.py protocol)."""
    from sgmcmc_tpu.metrics.convergence import convergence_summary
    s = _sampler(svm_obs)
    trace = s.fit_scan("SGLD", num_iters=40, epsilon=0.05, num_chains=4,
                       **KW)
    rows = convergence_summary(jax.device_get(trace), burn_frac=0.5)
    assert all(np.isfinite(r["rhat"]) for r in rows)
    assert all(r["num_chains"] == 4 and r["num_iters"] == 20 for r in rows)


# ----------------------------------------------------------------------
# record hardening (VERDICT r5 #6)
# ----------------------------------------------------------------------

def test_record_any_interval_truncates(svm_obs):
    s = _sampler(svm_obs)
    with pytest.warns(UserWarning, match="does not divide"):
        trace = s.fit_scan("SGLD", num_iters=10, record=3, **KW)
    assert np.asarray(trace.A).shape[0] == 3   # 9 iters run, 3 recorded


def test_record_interval_too_large_raises(svm_obs):
    s = _sampler(svm_obs)
    with pytest.raises(ValueError, match="exceeds num_iters"):
        s.fit_scan("SGLD", num_iters=5, record=10, **KW)


def test_record_all_size_guard_warns(svm_obs):
    s = _sampler(svm_obs)
    with pytest.warns(UserWarning, match="GiB"):
        s._record_plan(10 ** 6, 1, "all", num_chains=8192)


# ----------------------------------------------------------------------
# public multi-chip surface: fit_scan(mesh=... / n_particle_devices=...)
# (VERDICT r5 #4) — runs on the virtual 8-device CPU mesh
# ----------------------------------------------------------------------

def test_fit_scan_mesh_public_surface(svm_obs):
    s = _sampler(svm_obs)
    trace, aux = s.fit_scan("SGLD", num_iters=4, epsilon=0.01,
                            num_chains=8, n_particle_devices=2, record=2,
                            return_aux=True, **KW)
    A = np.asarray(trace.A)
    assert A.shape[:2] == (8, 2)               # [C, n_rec, ...]
    aux = np.asarray(aux)
    assert aux.shape == (8, 2) and np.all(np.isfinite(aux))
    assert s._num_chains == 8                  # stacked chains retained


def test_fit_scan_mesh_explicit_mesh_matches_particle_devices(svm_obs):
    from sgmcmc_tpu.parallel import sharding
    s = _sampler(svm_obs)
    mesh = sharding.make_mesh(n_chain_devices=2, n_particle_devices=4)
    trace = s.fit_scan("SGLD", num_iters=2, epsilon=0.01, num_chains=2,
                       mesh=mesh, **KW)
    assert np.asarray(trace.A).shape[:2] == (2, 2)
    assert np.all(np.isfinite(np.asarray(trace.A)))


def test_fit_scan_mesh_island_fused(svm_obs, interpret_kernels):
    s = SVMSampler(observations=jnp.asarray(svm_obs, jnp.float32), seed=3)
    s.parameters = svm_mod.from_scalars(A=0.5, Q=1.0, R=2.0,
                                        dtype=jnp.float32)
    trace = s.fit_scan("SGLD", num_iters=2, epsilon=0.01, num_chains=4,
                       n_particle_devices=2, island_fused=True,
                       N=32, subsequence_length=16, buffer_length=2,
                       resampler="systematic", resample_mode="fused",
                       warn_small_islands=False, record="all")
    A = np.asarray(trace.A)
    assert A.shape[:2] == (4, 2)
    assert np.all(np.isfinite(A))


def test_fit_scan_mesh_requires_sgld(svm_obs):
    s = _sampler(svm_obs)
    with pytest.raises(NotImplementedError, match="SGLD"):
        s.fit_scan("SGD", num_iters=2, n_particle_devices=2, **KW)


def test_fit_scan_mesh_record_none(svm_obs):
    s = _sampler(svm_obs)
    trace, aux = s.fit_scan("SGLD", num_iters=3, epsilon=0.01,
                            num_chains=4, n_particle_devices=2,
                            record="none", return_aux=True, **KW)
    assert trace is None
    assert np.asarray(aux).shape == (4, 3)


def test_fit_scan_chunked_nondividing_record(svm_obs):
    """Chunked fits size every chunk to a multiple of the record
    interval (code-review r5): no mid-run raise on an undersized
    remainder chunk, total recorded = floor coverage, one warning only
    for a dropped sub-interval tail."""
    s = _sampler(svm_obs)
    trace = s.fit_scan_chunked("SGLD", num_iters=10, chunk_iters=4,
                               record=2, num_chains=2, **KW)
    # chunks 4+4+2, every one divides record=2 -> 5 recorded iters
    assert np.asarray(trace.A).shape[:2] == (2, 5)
    s2 = _sampler(svm_obs)
    with pytest.warns(UserWarning, match="dropping the final"):
        trace2 = s2.fit_scan_chunked("SGLD", num_iters=7, chunk_iters=3,
                                     record=3, num_chains=2, **KW)
    assert np.asarray(trace2.A).shape[:2] == (2, 2)   # 3+3, 1 dropped
    with pytest.raises(ValueError, match="exceeds chunk_iters"):
        s2.fit_scan_chunked("SGLD", num_iters=10, chunk_iters=2,
                            record=5, num_chains=2, **KW)
