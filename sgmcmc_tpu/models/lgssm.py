"""Linear-Gaussian state-space model (LGSSM).

x_t = A x_{t-1} + N(0, Q),   y_t = C x_t + N(0, R)

Functional rewrite of `/root/reference/sgmcmc_ssm/models/lgssm/`.  The exact
Kalman machinery lives in `sgmcmc_tpu.ops.kalman`; this module provides the
parameter pytree (reference coordinates, `lgssm/parameters.py:18-57`), the
particle kernels (prior / locally-optimal, `lgssm/kernels.py:7-204`), the
Fisher-identity additive score (`lgssm/helper.py:1216-1277`), priors,
the SGRLD preconditioner (`lgssm/parameters.py:58-67`), conjugate Gibbs
updates (`lgssm/helper.py:502-555`, `variables/covariance.py:207-240`,
`variables/matrices.py:558-582`), and data generation
(`lgssm/parameters.py`).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import pytree

from ..ops import kalman
from ..utils.distributions import (matrix_normal_logpdf, sample_wishart,
                                   wishart_logpdf)
from ..utils.linalg import (lower_tri_mat_inv, mat_to_tril_vector,
                            pos_def_mat_inv, spectral_norm_projection,
                            tril_vector_to_mat, var_stationary_precision)
from .base import ParticleKernel

_LOG_2PI = float(np.log(2.0 * np.pi))


@pytree.dataclass
class LGSSMParams:
    """LGSSM parameter pytree (reference coordinates)."""
    A: jax.Array            # (n, n)
    C: jax.Array            # (m, n)
    LQinv_vec: jax.Array    # (n(n+1)/2,)
    LRinv_vec: jax.Array    # (m(m+1)/2,)

    @property
    def n(self):
        return self.A.shape[0]

    @property
    def m(self):
        return self.C.shape[0]

    @property
    def LQinv(self):
        return tril_vector_to_mat(self.LQinv_vec)

    @property
    def LRinv(self):
        return tril_vector_to_mat(self.LRinv_vec)

    @property
    def Qinv(self):
        L = self.LQinv
        return L @ L.T

    @property
    def Rinv(self):
        L = self.LRinv
        return L @ L.T

    @property
    def Q(self):
        return pos_def_mat_inv(self.Qinv)

    @property
    def R(self):
        return pos_def_mat_inv(self.Rinv)


def from_matrices(A, C, Q, R, dtype=jnp.float64) -> LGSSMParams:
    """Host-NumPy leaves (constructors must not dispatch device ops)."""
    import numpy as onp
    npdtype = onp.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    A = onp.atleast_2d(onp.asarray(A, npdtype))
    C = onp.atleast_2d(onp.asarray(C, npdtype))
    Q = onp.atleast_2d(onp.asarray(Q, npdtype))
    R = onp.atleast_2d(onp.asarray(R, npdtype))
    LQinv = onp.linalg.cholesky(onp.linalg.inv(Q))
    LRinv = onp.linalg.cholesky(onp.linalg.inv(R))
    rows_q, cols_q = onp.tril_indices(LQinv.shape[-1])
    rows_r, cols_r = onp.tril_indices(LRinv.shape[-1])
    return LGSSMParams(A=A, C=C, LQinv_vec=LQinv[rows_q, cols_q],
                       LRinv_vec=LRinv[rows_r, cols_r])


def default_forward_message(params: LGSSMParams) -> kalman.GaussianMessage:
    return kalman.init_forward_message(params.n, params.A.dtype)


def default_backward_message(params: LGSSMParams) -> kalman.GaussianMessage:
    return kalman.init_backward_message(params.n, params.A.dtype)


# --------------------------------------------------------------------------
# Exact (Kalman) interface — the correctness oracle
# --------------------------------------------------------------------------

def marginal_loglikelihood(params: LGSSMParams, observations,
                           forward_msg=None, backward_msg=None, weights=None,
                           valid=None):
    if forward_msg is None:
        forward_msg = default_forward_message(params)
    if backward_msg is None:
        backward_msg = default_backward_message(params)
    return kalman.marginal_loglikelihood(
        observations, params.A, params.C, params.LQinv, params.LRinv,
        forward_msg, backward_msg, weights, valid)


def parallel_marginal_loglikelihood(params: LGSSMParams, observations,
                                    forward_msg=None):
    """O(log T)-depth full-data loglikelihood via the associative-scan
    Kalman filter (`ops/kalman_parallel.py`); numerically equal to
    `marginal_loglikelihood` — use for long-sequence full-data passes."""
    from ..ops import kalman_parallel
    if forward_msg is None:
        forward_msg = default_forward_message(params)
    return kalman_parallel.parallel_marginal_loglikelihood(
        observations, params.A, params.C, params.LQinv, params.LRinv,
        forward_msg)


def parallel_latent_var_distr(params: LGSSMParams, observations,
                              smoothed: bool = True, forward_msg=None):
    """O(log T)-depth filtered/smoothed marginals (means, covs) via
    associative scans; matches `latent_var_distr`."""
    from ..ops import kalman_parallel
    if forward_msg is None:
        forward_msg = default_forward_message(params)
    if smoothed:
        return kalman_parallel.parallel_smoothed_moments(
            observations, params.A, params.C, params.LQinv, params.LRinv,
            forward_msg)
    fm = kalman_parallel.parallel_filtered_moments(
        observations, params.A, params.C, params.LQinv, params.LRinv,
        forward_msg)
    return fm.mean, fm.cov


def parallel_gradient_marginal_loglikelihood(params: LGSSMParams,
                                             observations,
                                             forward_msg=None
                                             ) -> LGSSMParams:
    """O(log T)-depth exact full-data score: autodiff through the
    associative-scan filter.  Matches `gradient_marginal_loglikelihood`;
    use for long-sequence full-data scores (KSD, LD baselines)."""
    return jax.grad(lambda p: parallel_marginal_loglikelihood(
        p, observations, forward_msg))(params)


def gradient_marginal_loglikelihood(params: LGSSMParams, observations,
                                    forward_msg=None, backward_msg=None,
                                    weights=None, include_init=True,
                                    valid=None) -> LGSSMParams:
    """Exact gradient as a LGSSMParams pytree (tril-packed Cholesky grads)."""
    if forward_msg is None:
        forward_msg = default_forward_message(params)
    if backward_msg is None:
        backward_msg = default_backward_message(params)
    g = kalman.gradient_marginal_loglikelihood(
        observations, params.A, params.C, params.LQinv, params.LRinv,
        forward_msg, backward_msg, weights, include_init, valid)
    return LGSSMParams(A=g['A'], C=g['C'],
                       LQinv_vec=mat_to_tril_vector(g['LQinv']),
                       LRinv_vec=mat_to_tril_vector(g['LRinv']))


def predictive_loglikelihood(params: LGSSMParams, observations, lag=1,
                             forward_msg=None):
    if forward_msg is None:
        forward_msg = default_forward_message(params)
    return kalman.predictive_loglikelihood(
        observations, params.A, params.C, params.LQinv, params.LRinv,
        forward_msg, lag)


def latent_var_sample(params: LGSSMParams, key, observations,
                      forward_msg=None, num_samples: int = 1,
                      distr: str = "joint", lag=None, backward_msg=None,
                      valid=None):
    """Posterior latent draws (`latent_var_sample`,
    `lgssm/helper.py:650-732`): ``distr='joint'`` FFBS paths;
    ``distr='marginal'`` independent per-t draws from the (optionally
    lagged) marginals."""
    if distr == "joint":
        if lag is not None:
            raise ValueError("Must set distr to 'marginal' for lag != None")
        if forward_msg is None:
            forward_msg = default_forward_message(params)
        return kalman.ffbs_sample(key, observations, params.A, params.C,
                                  params.LQinv, params.LRinv, forward_msg,
                                  num_samples, valid=valid)
    if valid is not None:
        raise ValueError("valid masking is only supported for distr='joint'")
    if distr != "marginal":
        raise ValueError(f"Unrecognized distr '{distr}'")
    mean, cov = latent_var_distr(params, observations, lag=lag,
                                 forward_msg=forward_msg,
                                 backward_msg=backward_msg)
    L = jnp.linalg.cholesky(cov)                      # [T, n, n]
    z = jax.random.normal(key, (num_samples,) + mean.shape,
                          observations.dtype)         # [S, T, n]
    x = mean[None] + jnp.einsum('tij,stj->sti', L, z)
    return x[0] if num_samples == 1 else x


def latent_var_distr(params: LGSSMParams, observations, lag=None,
                     forward_msg=None, backward_msg=None):
    """Marginals p(x_t | y_{<= t+lag}); lag=None -> smoothed
    (`latent_var_distr`, `lgssm/helper.py:558-648`).  Returns
    (mean [T, n], cov [T, n, n])."""
    if forward_msg is None:
        forward_msg = default_forward_message(params)
    if backward_msg is None:
        backward_msg = default_backward_message(params)
    if lag is None:
        return kalman.pairwise_smoothed_moments(
            observations, params.A, params.C, params.LQinv, params.LRinv,
            forward_msg, backward_msg)
    return kalman.lagged_moments(
        observations, params.A, params.C, params.LQinv, params.LRinv,
        forward_msg, backward_msg, int(lag))


def y_distr(params: LGSSMParams, observations, lag=None,
            forward_msg=None, backward_msg=None):
    """Observation marginals: mean = C x_mean, cov = C P C^T + R
    (`y_distr`, `lgssm/helper.py:819-846`)."""
    x_mean, x_cov = latent_var_distr(params, observations, lag,
                                     forward_msg, backward_msg)
    C, R = params.C, params.R
    y_mean = x_mean @ C.T
    y_cov = jnp.einsum('ij,tjk,lk->til', C, x_cov, C) + R
    return y_mean, y_cov


def y_sample(params: LGSSMParams, key, observations, num_samples: int = 1,
             forward_msg=None, distr: str = "joint", lag=None):
    """Posterior-predictive draws of y_{0:T-1}: latent draws (joint FFBS
    paths or per-t marginals, per ``distr``) plus emission noise
    (`y_sample`, `lgssm/helper.py:880-909`)."""
    key_x, key_eps = jax.random.split(key)
    x = latent_var_sample(params, key_x, observations, forward_msg,
                          num_samples, distr=distr, lag=lag)
    LR = jnp.linalg.cholesky(params.R)
    eps = jax.random.normal(key_eps, x.shape[:-1] + (params.m,),
                            observations.dtype)
    return x @ params.C.T + eps @ LR.T


def simulate_distr(params: LGSSMParams, T: int, init_message=None,
                   include_init: bool = True):
    """Prior moment propagation (`simulate_distr`,
    `lgssm/helper.py:911-957`): dict of latent/observation mean + cov
    trajectories of length T+1 (or T without the init element)."""
    if init_message is None:
        init_message = default_forward_message(params)
    A, C, Q, R = params.A, params.C, params.Q, params.R
    m0 = jnp.linalg.solve(init_message.precision,
                          init_message.mean_precision)
    P0 = jnp.linalg.inv(init_message.precision)

    def step(carry, _):
        mean, cov = carry
        mean = A @ mean
        cov = A @ cov @ A.T + Q
        return (mean, cov), (mean, cov)

    _, (means, covs) = jax.lax.scan(step, (m0, P0), None, length=T)
    means = jnp.concatenate([m0[None], means])
    covs = jnp.concatenate([P0[None], covs])
    if not include_init:
        means, covs = means[1:], covs[1:]
    return dict(latent_vars_mean=means, latent_vars_cov=covs,
                obs_mean=means @ C.T,
                obs_cov=jnp.einsum('ij,tjk,lk->til', C, covs, C) + R)


def simulate_paths(params: LGSSMParams, key, T: int, num_samples: int = 1,
                   init_message=None, include_init: bool = True):
    """Joint prior samples of (x, y) trajectories (`simulate`,
    `lgssm/helper.py:959-1014`).  Returns dict(latent_vars [S?, T(+1), n],
    observations [S?, T(+1), m]); leading sample axis dropped when
    num_samples == 1."""
    if init_message is None:
        init_message = default_forward_message(params)
    A, C = params.A, params.C
    LQ = jnp.linalg.cholesky(params.Q)
    LR = jnp.linalg.cholesky(params.R)
    m0 = jnp.linalg.solve(init_message.precision,
                          init_message.mean_precision)
    L0 = jnp.linalg.cholesky(jnp.linalg.inv(init_message.precision))

    def one(k):
        k0, kx, ky = jax.random.split(k, 3)
        x0 = m0 + L0 @ jax.random.normal(k0, (params.n,), A.dtype)
        zx = jax.random.normal(kx, (T, params.n), A.dtype)
        zy = jax.random.normal(ky, (T + 1, params.m), A.dtype)

        def step(x, z):
            x = A @ x + LQ @ z
            return x, x

        _, xs = jax.lax.scan(step, x0, zx)
        xs = jnp.concatenate([x0[None], xs])
        ys = xs @ C.T + zy @ LR.T
        if not include_init:
            return xs[1:], ys[1:]
        return xs, ys

    keys = jax.random.split(key, num_samples)
    xs, ys = jax.vmap(one)(keys)
    if num_samples == 1:
        xs, ys = xs[0], ys[0]
    return dict(latent_vars=xs, observations=ys)


def windowed_marginal_gradient(params: LGSSMParams, window, valid, weights,
                               B: int, S: int):
    """Buffered exact-gradient estimator over one fixed-shape window.

    ``window`` is [B | S | B] rows with ``valid`` masking edge clipping —
    the jittable equivalent of `_single_noisy_grad_loglikelihood`
    kind='marginal' (`sgmcmc_sampler.py:298-329`): boundary messages run
    over the buffers from the default messages; the weighted gradient and
    marginal loglikelihood are over the central subsequence.
    """
    fwd0 = default_forward_message(params)
    bwd0 = default_backward_message(params)
    fwd = kalman.forward_message(window[:B], params.A, params.C,
                                 params.LQinv, params.LRinv, fwd0,
                                 valid=valid[:B]) if B else fwd0
    bwd = kalman.backward_message(window[B + S:], params.A, params.C,
                                  params.LQinv, params.LRinv, bwd0,
                                  valid=valid[B + S:]) if B else bwd0
    sub = window[B:B + S]
    v_sub = valid[B:B + S]
    grad = gradient_marginal_loglikelihood(params, sub, fwd, bwd, weights,
                                           valid=v_sub)
    loglik = marginal_loglikelihood(params, sub, fwd, bwd, weights,
                                    valid=v_sub)
    return grad, loglik


def windowed_complete_gradient(params: LGSSMParams, window, valid, weights,
                               B: int, S: int, key,
                               num_samples: int = 1):
    """kind='complete' buffered estimator: FFBS latent draws over the
    window, then the weighted complete-data score over the subsequence
    (`_single_noisy_grad_loglikelihood` kind='complete',
    `sgmcmc_sampler.py:330-362`).

    The complete-data loglikelihood is closed form, so the score is its
    autodiff — numerically identical to the reference's hand-derived
    `gradient_complete_data_loglikelihood` (`lgssm/helper.py:422-491`).

    Deliberate delta from the reference: at the sequence start (no valid
    buffer row before the subsequence) the reference drops the first
    transition term (`helper.py:443-445` skips when x_prev is None) —
    leaving the complete-data score biased relative to the exact marginal
    gradient, whose first pairwise smoothed moment carries the implicit
    x_{-1} ~ init-message transition.  Here the pre-window latent is
    completed exactly instead: x_prev | x_first ~ N(J_c^{-1} h_c, J_c^{-1})
    with J_c = J_0 + A'Q^{-1}A, h_c = h_0 + A'Q^{-1} x_first (y never
    touches x_{-1}), restoring the Fisher identity E[grad complete] =
    grad marginal exactly (`tests/test_valid_ffbs.py`).
    """
    fmsg0 = default_forward_message(params)
    fmsg = kalman.GaussianMessage(
        jnp.zeros((), window.dtype), fmsg0.mean_precision, fmsg0.precision)
    Qinv = params.LQinv @ params.LQinv.T
    AtQinv = params.A.T @ Qinv
    Jc = fmsg0.precision + AtQinv @ params.A

    def one_sample(k):
        k_ffbs, k_prev = jax.random.split(k)
        x = kalman.ffbs_sample(k_ffbs, window, params.A, params.C,
                               params.LQinv, params.LRinv, fmsg, valid=valid)
        x = jax.lax.stop_gradient(x)
        # pre-subsequence latent: the sampled buffer row when it is a real
        # observation, else the exact init-message completion given the
        # first subsequence draw
        hc = fmsg0.mean_precision + AtQinv @ x[B]
        mean_c = jnp.linalg.solve(Jc, hc)
        Lc = jnp.linalg.cholesky(Jc)
        z = jax.random.normal(k_prev, mean_c.shape, window.dtype)
        x_init = mean_c + jax.scipy.linalg.solve_triangular(
            Lc.T, z, lower=False)
        x_init = jax.lax.stop_gradient(x_init)
        if B > 0:
            x_prev = jnp.where(valid[B - 1] > 0, x[B - 1], x_init)
        else:
            x_prev = x_init

        def cdl(p):
            return complete_data_loglikelihood(
                p, window[B:B + S], x[B:B + S], x_prev=x_prev,
                weights=weights)

        return jax.grad(cdl)(params), cdl(params)

    grads, lls = jax.vmap(one_sample)(jax.random.split(key, num_samples))
    grad = jax.tree_util.tree_map(lambda g: jnp.mean(g, axis=0), grads)
    return grad, jnp.mean(lls)


def complete_data_loglikelihood(params: LGSSMParams, observations,
                                latent_vars, x_prev=None, weights=None):
    """log p(y, x | theta) (`lgssm/helper.py:235-266`), vectorized over t."""
    T = observations.shape[0]
    dtype = observations.dtype
    if weights is None:
        weights = jnp.ones((T,), dtype)
    A, C, LQinv, LRinv = params.A, params.C, params.LQinv, params.LRinv
    n, m = params.n, params.m

    x = latent_vars
    # Emissions
    diff = observations - x @ C.T
    z = diff @ LRinv
    log_emit = (-0.5 * m * _LOG_2PI
                + jnp.sum(jnp.log(jnp.abs(jnp.diag(LRinv))))
                - 0.5 * jnp.sum(z * z, axis=-1))
    total = jnp.sum(weights * log_emit)
    # Transitions within the window
    diff_x = x[1:] - x[:-1] @ A.T
    zx = diff_x @ LQinv
    log_trans = (-0.5 * n * _LOG_2PI
                 + jnp.sum(jnp.log(jnp.abs(jnp.diag(LQinv))))
                 - 0.5 * jnp.sum(zx * zx, axis=-1))
    total += jnp.sum(weights[1:] * log_trans)
    if x_prev is not None:
        d0 = (x[0] - A @ x_prev) @ LQinv
        total += weights[0] * (-0.5 * n * _LOG_2PI
                               + jnp.sum(jnp.log(jnp.abs(jnp.diag(LQinv))))
                               - 0.5 * jnp.sum(d0 * d0))
    return total


# --------------------------------------------------------------------------
# Particle kernels (`lgssm/kernels.py`)
# --------------------------------------------------------------------------

def _sample_x0(params: LGSSMParams, key, n_particles, prior_mean, prior_var):
    n = params.n
    z = jax.random.normal(key, (n_particles, n), dtype=params.A.dtype)
    prior_var = jnp.asarray(prior_var, params.A.dtype)
    if prior_var.ndim < 2:
        scale = jnp.sqrt(prior_var) * jnp.ones((n,), params.A.dtype)
        return prior_mean + z * scale
    L = jnp.linalg.cholesky(prior_var)
    return prior_mean + z @ L.T


def _propose_prior(params: LGSSMParams, key, x_t, y_next):
    """x' ~ N(A x, Q) (`LGSSMPriorKernel.rv`, `lgssm/kernels.py:7-40`)."""
    z = jax.random.normal(key, x_t.shape, dtype=x_t.dtype)
    LQinv = params.LQinv
    noise = jax.scipy.linalg.solve_triangular(LQinv.T, z.T, lower=False).T
    return x_t @ params.A.T + noise


def _reweight_prior(params: LGSSMParams, x_t, x_next, y_next):
    """log N(y'; C x', R)."""
    diff = y_next[None, :] - x_next @ params.C.T
    z = diff @ params.LRinv
    return (-0.5 * params.m * _LOG_2PI
            + jnp.sum(jnp.log(jnp.abs(jnp.diag(params.LRinv))))
            - 0.5 * jnp.sum(z * z, axis=-1))


def _propose_optimal(params: LGSSMParams, key, x_t, y_next):
    """x' ~ p(x' | x, y') — locally optimal proposal
    (`LGSSMOptimalKernel`/`LGSSMHighDimOptimalKernel`,
    `lgssm/kernels.py:67-204`)."""
    Qinv, Rinv = params.Qinv, params.Rinv
    CtRinv = params.C.T @ Rinv
    J = Qinv + CtRinv @ params.C
    Sigma = pos_def_mat_inv(J)
    L = jnp.linalg.cholesky(Sigma)
    mean = (x_t @ params.A.T) @ Qinv.T + y_next[None, :] @ CtRinv.T
    mean = mean @ Sigma.T
    z = jax.random.normal(key, x_t.shape, dtype=x_t.dtype)
    return mean + z @ L.T


def _reweight_optimal(params: LGSSMParams, x_t, x_next, y_next):
    """log p(y' | x) = log N(y'; C A x, C Q C^T + R)."""
    Q, R = params.Q, params.R
    y_cov = params.C @ Q @ params.C.T + R
    y_prec = pos_def_mat_inv(y_cov)
    diff = y_next[None, :] - (x_t @ params.A.T) @ params.C.T
    quad = jnp.sum((diff @ y_prec) * diff, axis=-1)
    return (-0.5 * params.m * _LOG_2PI
            - 0.5 * jnp.linalg.slogdet(y_cov)[1]
            - 0.5 * quad)


def _prior_log_density(params: LGSSMParams, x_t, x_next):
    diff = x_next - x_t @ params.A.T
    z = diff @ params.LQinv
    return (-0.5 * params.n * _LOG_2PI
            + jnp.sum(jnp.log(jnp.abs(jnp.diag(params.LQinv))))
            - 0.5 * jnp.sum(z * z, axis=-1))


def _prior_log_density_max(params: LGSSMParams):
    return (-0.5 * params.n * _LOG_2PI
            + jnp.sum(jnp.log(jnp.abs(jnp.diag(params.LQinv)))))


PRIOR_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_prior, reweight=_reweight_prior,
    prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=1)

OPTIMAL_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_optimal,
    reweight=_reweight_optimal,
    prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=1)


def get_kernel(name: str | None = None) -> ParticleKernel:
    """`_get_kernel` (`lgssm/helper.py:1200-1214`): default optimal."""
    if name in (None, "optimal", "highdim"):
        return OPTIMAL_KERNEL
    if name == "prior":
        return PRIOR_KERNEL
    raise ValueError(f"Unrecognized LGSSM kernel '{name}'")


# --------------------------------------------------------------------------
# Additive statistics (`lgssm/helper.py:1216-1363`)
# --------------------------------------------------------------------------

def statistic_dim(n: int, m: int) -> int:
    """[grad_LRinv_vec, grad_LQinv_vec, grad_C, grad_A] packed dims."""
    return (m * (m + 1)) // 2 + (n * (n + 1)) // 2 + m * n + n * n


def grad_statistic(params: LGSSMParams, x_t, x_next, y_next, t):
    """Per-particle gradient of log Pr(y', x' | x, theta), [N, p]."""
    A, C, LQinv, LRinv = params.A, params.C, params.LQinv, params.LRinv
    Qinv, Rinv = params.Qinv, params.Rinv
    n, m = params.n, params.m
    LQinv_Tinv = lower_tri_mat_inv(LQinv).T
    LRinv_Tinv = lower_tri_mat_inv(LRinv).T

    diff = x_next - x_t @ A.T                              # [N, n]
    grad_A = jnp.einsum('in,Nn,Nj->Nij', Qinv, diff, x_t)
    outer_q = jnp.einsum('Ni,Nj->Nij', diff, diff)
    grad_LQinv = LQinv_Tinv[None] - outer_q @ LQinv

    diff_y = y_next[None, :] - x_next @ C.T                # [N, m]
    grad_C = jnp.einsum('im,Nm,Nj->Nij', Rinv, diff_y, x_next)
    outer_r = jnp.einsum('Ni,Nj->Nij', diff_y, diff_y)
    grad_LRinv = LRinv_Tinv[None] - outer_r @ LRinv

    rows_q, cols_q = np.tril_indices(n)
    rows_r, cols_r = np.tril_indices(m)
    N = x_t.shape[0]
    return jnp.concatenate([
        grad_LRinv[:, rows_r, cols_r].reshape(N, -1),
        grad_LQinv[:, rows_q, cols_q].reshape(N, -1),
        grad_C.reshape(N, -1),
        grad_A.reshape(N, -1),
    ], axis=-1)


def suff_statistic(params: LGSSMParams, x_t, x_next, y_next, t):
    """Gaussian sufficient stats (`lgssm/helper.py:1338-1363`)."""
    n = params.n
    N = x_t.shape[0]
    if n == 1:
        x0, x1 = x_t[:, 0], x_next[:, 0]
        return jnp.stack([x1, x1 * x1, x0 * x1], axis=-1)
    return jnp.concatenate([
        x_next,
        jnp.einsum('Ni,Nj->Nij', x_next, x_next).reshape(N, -1),
        jnp.einsum('Ni,Nj->Nij', x_t, x_next).reshape(N, -1),
    ], axis=-1)


def _parse_latent_suff(params: LGSSMParams, stats):
    """Elementwise-averaged suff stats [T, H] -> (x_mean [T,n],
    x_cov [T,n,n]) (`pf_latent_var_distr`, `lgssm/helper.py:1145-1198`)."""
    n = params.n
    if n == 1:
        x_mean = stats[:, 0:1]
        x_cov = (stats[:, 1] - stats[:, 0] ** 2)[:, None, None]
        return x_mean, x_cov
    x_mean = stats[:, :n]
    second = stats[:, n:n + n * n].reshape(-1, n, n)
    x_cov = second - jnp.einsum('ti,tj->tij', x_mean, x_mean)
    return x_mean, x_cov


def latent_moments(params: LGSSMParams, stats):
    return _parse_latent_suff(params, stats)


def y_moments(params: LGSSMParams, stats):
    """Suff stats [T, H] -> observation moments: y_mean = C x_mean,
    y_cov = C P C^T + R (analytic `y_distr`, `lgssm/helper.py:819-846`,
    applied to PF-estimated latent moments)."""
    x_mean, x_cov = _parse_latent_suff(params, stats)
    C, R = params.C, params.R
    y_mean = x_mean @ C.T
    y_cov = jnp.einsum('ij,tjk,lk->til', C, x_cov, C) + R
    return y_mean, y_cov


def make_predictive_stat_fn(observations, num_steps_ahead: int,
                            base_key=None, valid_length=None):
    """k-step-ahead Gaussian predictive-loglikelihood statistic
    (`gaussian_predictive_loglikelihood`, `lgssm/helper.py:1281-1336`):
    propagate per-particle moments through (A, Q) and score y_{t+k}
    under N(C x_pred, C P_pred C^T + R).  Returns [N, K+1].

    ``valid_length`` (traced scalar) masks horizons past the true sequence
    end for padded multi-sequence batching."""
    T = observations.shape[0]
    T_valid = T if valid_length is None else valid_length

    def stat_fn(params, x_t, x_next, y_next, t):
        A, C, Q, R = params.A, params.C, params.Q, params.R
        n, m = params.n, params.m
        dtype = x_next.dtype
        out = []
        x_pred = x_next                                  # [N, n]
        P_pred = jnp.zeros((n, n), dtype)
        for k in range(num_steps_ahead + 1):
            tk = jnp.clip(t + k, 0, T - 1)
            in_range = (t + k < T_valid).astype(dtype)
            diff = observations[tk][None, :] - x_pred @ C.T   # [N, m]
            y_cov = R + C @ P_pred @ C.T                      # [m, m]
            sol = jnp.linalg.solve(y_cov, diff.T).T
            ll = (-0.5 * jnp.sum(diff * sol, axis=-1)
                  - 0.5 * m * _LOG_2PI
                  - 0.5 * jnp.linalg.slogdet(y_cov)[1])
            out.append(in_range * ll)
            x_pred = x_pred @ A.T
            P_pred = Q + A @ P_pred @ A.T
        return jnp.stack(out, axis=-1)

    return stat_fn


# --------------------------------------------------------------------------
# Fused-kernel bundles for the scalar (n = m = 1) case — the configuration
# of every reference experiment.  See `ops/pallas/fused_pf.py`.
# --------------------------------------------------------------------------

def _fused_pack(params: LGSSMParams) -> jax.Array:
    return jnp.stack([params.A[0, 0], params.C[0, 0],
                      params.LQinv_vec[0], params.LRinv_vec[0]])


def _fused_propose_prior(pv, z, x, y_t):
    a, _, lqinv, _ = pv
    return [a * x[0] + z[0] / lqinv]


def _fused_reweight_prior(pv, x, x_new, y_t):
    _, c, _, lrinv = pv
    diff = (y_t - c * x_new[0]) * lrinv
    return (-0.5 * _LOG_2PI + jnp.log(jnp.abs(lrinv)) - 0.5 * diff * diff)


def _fused_propose_optimal(pv, z, x, y_t):
    a, c, lqinv, lrinv = pv
    qinv = lqinv * lqinv
    rinv = lrinv * lrinv
    sigma = 1.0 / (qinv + c * c * rinv)
    mean = sigma * (a * x[0] * qinv + y_t * c * rinv)
    return [mean + jnp.sqrt(sigma) * z[0]]


def _fused_reweight_optimal(pv, x, x_new, y_t):
    a, c, lqinv, lrinv = pv
    y_var = c * c / (lqinv * lqinv) + 1.0 / (lrinv * lrinv)
    diff = y_t - c * a * x[0]
    return (-0.5 * _LOG_2PI - 0.5 * jnp.log(y_var)
            - 0.5 * diff * diff / y_var)


def _fused_stat(pv, x, x_new, y_t):
    """Scalar fast path of `lgssm_complete_data_loglike_gradient`
    (`lgssm/helper.py:1269-1277`); order matches `unpack_grad`."""
    a, c, lqinv, lrinv = pv
    diff = x_new[0] - a * x[0]
    grad_A = (lqinv * lqinv) * diff * x[0]
    grad_LQinv = 1.0 / lqinv - diff * diff * lqinv
    diff_y = y_t - c * x_new[0]
    grad_C = (lrinv * lrinv) * diff_y * x_new[0]
    grad_LRinv = 1.0 / lrinv - diff_y * diff_y * lrinv
    return [grad_LRinv, grad_LQinv, grad_C, grad_A]


def _make_fused():
    from ..ops.pallas.fused_pf import FusedModel
    common = dict(n_state=1, n_stat=4, n_param=4, pack_params=_fused_pack,
                  stat=_fused_stat)
    return (FusedModel(propose=_fused_propose_optimal,
                       reweight=_fused_reweight_optimal, **common),
            FusedModel(propose=_fused_propose_prior,
                       reweight=_fused_reweight_prior, **common))


FUSED, FUSED_PRIOR = _make_fused()


def get_fused(name: str | None = None):
    """Fused bundle matching `get_kernel` — scalar models only (the
    registry wires this in only for n = m = 1)."""
    if name in (None, "optimal", "highdim"):
        return FUSED
    if name == "prior":
        return FUSED_PRIOR
    raise ValueError(f"Unrecognized LGSSM kernel '{name}'")


def unpack_grad(stat: jax.Array, n: int, m: int) -> LGSSMParams:
    dr = (m * (m + 1)) // 2
    dq = (n * (n + 1)) // 2
    i = 0
    LRinv_vec = stat[i:i + dr]; i += dr
    LQinv_vec = stat[i:i + dq]; i += dq
    C = stat[i:i + m * n].reshape(m, n); i += m * n
    A = stat[i:i + n * n].reshape(n, n)
    return LGSSMParams(A=A, C=C, LQinv_vec=LQinv_vec, LRinv_vec=LRinv_vec)


# --------------------------------------------------------------------------
# Prior (`lgssm/parameters.py:44-56`)
# --------------------------------------------------------------------------

@pytree.dataclass
class LGSSMPrior:
    mean_A: jax.Array        # (n, n)
    var_col_A: jax.Array     # (n,)
    mean_C: jax.Array        # (m, n)
    var_col_C: jax.Array     # (n,)
    scale_Qinv: jax.Array    # (n, n)
    df_Qinv: jax.Array       # ()
    scale_Rinv: jax.Array    # (m, m)
    df_Rinv: jax.Array       # ()


def default_prior(n: int = 1, m: int = 1, var: float = 100.0,
                  dtype=jnp.float64) -> LGSSMPrior:
    """Host-NumPy leaves (no eager device dispatch)."""
    import numpy as onp
    npdtype = onp.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    df_q = n + 1.0 + 1.0 / var
    df_r = m + 1.0 + 1.0 / var
    return LGSSMPrior(
        mean_A=onp.zeros((n, n), npdtype),
        var_col_A=onp.full((n,), var, npdtype),
        mean_C=onp.zeros((m, n), npdtype),
        var_col_C=onp.full((n,), var, npdtype),
        scale_Qinv=onp.eye(n, dtype=npdtype) / df_q,
        df_Qinv=onp.asarray(df_q, npdtype),
        scale_Rinv=onp.eye(m, dtype=npdtype) / df_r,
        df_Rinv=onp.asarray(df_r, npdtype),
    )


def _cov_grad_logprior(L, df, scale):
    """(df - n - 1) inv(L)^T - solve(scale, L) (`covariance.py:252-260`)."""
    n = L.shape[0]
    return ((df - n - 1) * lower_tri_mat_inv(L).T
            - jnp.linalg.solve(scale, L))


def logprior(prior: LGSSMPrior, params: LGSSMParams) -> jax.Array:
    LQinv, LRinv = params.LQinv, params.LRinv
    lp = wishart_logpdf(LQinv @ LQinv.T, prior.df_Qinv, prior.scale_Qinv)
    lp += wishart_logpdf(LRinv @ LRinv.T, prior.df_Rinv, prior.scale_Rinv)
    lp += matrix_normal_logpdf(params.A, prior.mean_A, Lrowprec=LQinv,
                               Lcolprec=jnp.diag(prior.var_col_A ** -0.5))
    lp += matrix_normal_logpdf(params.C, prior.mean_C, Lrowprec=LRinv,
                               Lcolprec=jnp.diag(prior.var_col_C ** -0.5))
    return lp


def grad_logprior(prior: LGSSMPrior, params: LGSSMParams) -> LGSSMParams:
    """Prior score with reference semantics: the matrix-normal priors on
    A/C treat their row covariances (Q/R) as constants
    (`covariance.py:252-260`, `matrices.py:602-612`)."""
    gq = _cov_grad_logprior(params.LQinv, prior.df_Qinv, prior.scale_Qinv)
    gr = _cov_grad_logprior(params.LRinv, prior.df_Rinv, prior.scale_Rinv)
    gA = -(params.Qinv @ (params.A - prior.mean_A)) / prior.var_col_A[None, :]
    gC = -(params.Rinv @ (params.C - prior.mean_C)) / prior.var_col_C[None, :]
    return LGSSMParams(A=gA, C=gC, LQinv_vec=mat_to_tril_vector(gq),
                       LRinv_vec=mat_to_tril_vector(gr))


def sample_prior(prior: LGSSMPrior, key) -> LGSSMParams:
    kq, kr, ka, kc = jax.random.split(key, 4)
    dtype = prior.mean_A.dtype
    n, m = prior.mean_A.shape[0], prior.mean_C.shape[0]
    Qinv = sample_wishart(kq, prior.df_Qinv, prior.scale_Qinv)
    Rinv = sample_wishart(kr, prior.df_Rinv, prior.scale_Rinv)
    LQinv = jnp.linalg.cholesky(Qinv)
    LRinv = jnp.linalg.cholesky(Rinv)
    # A | Q ~ MN(mean_A, Q, diag(var_col_A)); row factor via LQinv^-T z
    ZA = jax.random.normal(ka, (n, n), dtype)
    A = prior.mean_A + jax.scipy.linalg.solve_triangular(
        LQinv.T, ZA, lower=False) * jnp.sqrt(prior.var_col_A)[None, :]
    ZC = jax.random.normal(kc, (m, n), dtype)
    C = prior.mean_C + jax.scipy.linalg.solve_triangular(
        LRinv.T, ZC, lower=False) * jnp.sqrt(prior.var_col_C)[None, :]
    return LGSSMParams(A=A, C=C, LQinv_vec=mat_to_tril_vector(LQinv),
                       LRinv_vec=mat_to_tril_vector(LRinv))


# --------------------------------------------------------------------------
# Preconditioner (`lgssm/parameters.py:58-67`, `matrices.py:632-657`,
# `covariance.py:286-317`)
# --------------------------------------------------------------------------

def precondition(params: LGSSMParams, grad: LGSSMParams) -> LGSSMParams:
    Q, R = params.Q, params.R
    Qinv, Rinv = params.Qinv, params.Rinv
    gLQ = tril_vector_to_mat(grad.LQinv_vec)
    gLR = tril_vector_to_mat(grad.LRinv_vec)
    return LGSSMParams(
        A=Q @ grad.A,
        C=R @ grad.C,
        LQinv_vec=mat_to_tril_vector(0.5 * Qinv @ gLQ),
        LRinv_vec=mat_to_tril_vector(0.5 * Rinv @ gLR),
    )


def precondition_noise(params: LGSSMParams, key) -> LGSSMParams:
    kA, kC, kQ, kR = jax.random.split(key, 4)
    dtype = params.A.dtype
    n, m = params.n, params.m
    LQinv, LRinv = params.LQinv, params.LRinv
    zA = jax.random.normal(kA, (n, n), dtype)
    noise_A = jax.scipy.linalg.solve_triangular(LQinv.T, zA, lower=False)
    zC = jax.random.normal(kC, (m, n), dtype)
    noise_C = jax.scipy.linalg.solve_triangular(LRinv.T, zC, lower=False)
    zQ = jax.random.normal(kQ, (n, n), dtype)
    noise_LQ = jnp.sqrt(0.5) * LQinv @ zQ
    zR = jax.random.normal(kR, (m, m), dtype)
    noise_LR = jnp.sqrt(0.5) * LRinv @ zR
    return LGSSMParams(A=noise_A, C=noise_C,
                       LQinv_vec=mat_to_tril_vector(noise_LQ),
                       LRinv_vec=mat_to_tril_vector(noise_LR))


def correction_term(params: LGSSMParams) -> LGSSMParams:
    n, m = params.n, params.m
    return LGSSMParams(
        A=jnp.zeros_like(params.A),
        C=jnp.zeros_like(params.C),
        LQinv_vec=0.5 * (n + 1) * params.LQinv_vec,
        LRinv_vec=0.5 * (m + 1) * params.LRinv_vec,
    )


# --------------------------------------------------------------------------
# Projection
# --------------------------------------------------------------------------

def project_parameters(params: LGSSMParams, a_threshold: float = 0.9999,
                       fix_C_eye: bool = True) -> LGSSMParams:
    """VAR-stability projection on A, positive Cholesky diagonals, and the
    default C = I identifiability constraint (`lgssm/parameters.py:39-42`)."""
    A = spectral_norm_projection(params.A, a_threshold)
    LQ = tril_vector_to_mat(params.LQinv_vec)
    LR = tril_vector_to_mat(params.LRinv_vec)

    def fix_chol(L):
        idx = jnp.arange(L.shape[0])
        return L.at[idx, idx].set(jnp.abs(jnp.diag(L)))

    C = jnp.eye(params.m, params.n, dtype=params.C.dtype) if fix_C_eye \
        else params.C
    return LGSSMParams(A=A, C=C,
                       LQinv_vec=mat_to_tril_vector(fix_chol(LQ)),
                       LRinv_vec=mat_to_tril_vector(fix_chol(LR)))


# --------------------------------------------------------------------------
# Gibbs (conjugate) updates (`lgssm/sampler.py:79-96`)
# --------------------------------------------------------------------------

def gibbs_sufficient_statistics(observations, latent_vars):
    """Fox-thesis sufficient statistics (`lgssm/helper.py:502-555`)."""
    x, y = latent_vars, observations
    return dict(
        Sx_prevprev=x[:-1].T @ x[:-1],
        Sx_curprev=x[1:].T @ x[:-1],
        Sx_curcur=x[1:].T @ x[1:],
        x_count=x.shape[0] - 1,
        Sy_prevprev=x.T @ x,
        Sy_curprev=y.T @ x,
        Sy_curcur=y.T @ y,
        y_count=y.shape[0],
    )


def _conjugate_mniw_sample(key, S_prevprev, S_curprev, S_curcur, count,
                           mean_M, var_col, scale_Vinv, df_Vinv):
    """Sample (Vinv, M) from the matrix-normal-Wishart posterior
    (`covariance.py:207-240` + `matrices.py:558-582`)."""
    dtype = mean_M.dtype
    prec = jnp.diag(1.0 / var_col)
    Spp = prec + S_prevprev
    Scp = mean_M / var_col[None, :] + S_curprev
    Scc = (mean_M / var_col[None, :]) @ mean_M.T + S_curcur
    S_schur = Scc - Scp @ jnp.linalg.solve(Spp, Scp.T)
    df_post = df_Vinv + count
    scale_post = jnp.linalg.inv(jnp.linalg.inv(scale_Vinv) + S_schur)
    k_v, k_m = jax.random.split(key)
    Vinv = sample_wishart(k_v, df_post, scale_post)
    LVinv = jnp.linalg.cholesky(Vinv)
    # M | V ~ MN(solve(Spp, Scp.T).T, V, inv(Spp))
    M_mean = jnp.linalg.solve(Spp, Scp.T).T
    L_col = jnp.linalg.cholesky(jnp.linalg.inv(Spp))
    Z = jax.random.normal(k_m, mean_M.shape, dtype)
    M = M_mean + jax.scipy.linalg.solve_triangular(
        LVinv.T, Z, lower=False) @ L_col.T
    return Vinv, M


def gibbs_parameters_sample(key, prior: LGSSMPrior, observations,
                            latent_vars,
                            fix_C_eye: bool = True) -> LGSSMParams:
    """theta | x, y — conjugate block updates for (Q, A) and (R, C).

    With ``fix_C_eye`` (the reference's default identifiability constraint,
    `lgssm/parameters.py:39-42`) Rinv is drawn conditional on C = I —
    Wishart with the residual scatter of ``y - x`` — so the chain targets
    exactly the fixed-C model posterior.  (The reference instead samples
    the free-C MNIW block and *projects* C back to I, which leaves the
    (C, Q, x-scale) direction non-identified inside each sweep; that free
    variant is ``fix_C_eye=False``.)
    """
    ss = gibbs_sufficient_statistics(observations, latent_vars)
    k1, k2 = jax.random.split(key)
    Qinv, A = _conjugate_mniw_sample(
        k1, ss['Sx_prevprev'], ss['Sx_curprev'], ss['Sx_curcur'],
        ss['x_count'], prior.mean_A, prior.var_col_A,
        prior.scale_Qinv, prior.df_Qinv)
    if fix_C_eye:
        C = jnp.eye(observations.shape[-1], latent_vars.shape[-1],
                    dtype=prior.mean_C.dtype)
        S_emit = (ss['Sy_curcur'] - C @ ss['Sy_curprev'].T
                  - ss['Sy_curprev'] @ C.T + C @ ss['Sy_prevprev'] @ C.T)
        df_post = prior.df_Rinv + ss['y_count']
        scale_post = jnp.linalg.inv(jnp.linalg.inv(prior.scale_Rinv)
                                    + S_emit)
        Rinv = sample_wishart(k2, df_post, scale_post)
    else:
        Rinv, C = _conjugate_mniw_sample(
            k2, ss['Sy_prevprev'], ss['Sy_curprev'], ss['Sy_curcur'],
            ss['y_count'], prior.mean_C, prior.var_col_C,
            prior.scale_Rinv, prior.df_Rinv)
    return LGSSMParams(A=A, C=C,
                       LQinv_vec=mat_to_tril_vector(jnp.linalg.cholesky(Qinv)),
                       LRinv_vec=mat_to_tril_vector(jnp.linalg.cholesky(Rinv)))


def gibbs_step(key, prior: LGSSMPrior, params: LGSSMParams, observations,
               forward_msg=None) -> LGSSMParams:
    """One blocked-Gibbs sweep: x | theta via FFBS, then theta | x."""
    k_x, k_p = jax.random.split(key)
    x = latent_var_sample(params, k_x, observations, forward_msg)
    return gibbs_parameters_sample(k_p, prior, observations, x)


# --------------------------------------------------------------------------
# Data generation
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("T",))
def generate_data(key, params: LGSSMParams, T: int):
    """Simulate (observations [T, m], latent [T, n])."""
    dtype = params.A.dtype
    n, m = params.n, params.m
    k0, kx, ky = jax.random.split(key, 3)
    init_prec = var_stationary_precision(params.Qinv, params.A, 10)
    L0 = jnp.linalg.cholesky(jnp.linalg.inv(init_prec))
    x0 = L0 @ jax.random.normal(k0, (n,), dtype)
    LQ = jnp.linalg.cholesky(params.Q)
    LR = jnp.linalg.cholesky(params.R)
    zx = jax.random.normal(kx, (T, n), dtype)
    zy = jax.random.normal(ky, (T, m), dtype)

    def body(x_prev, z):
        zx_t, zy_t = z
        x = params.A @ x_prev + LQ @ zx_t
        y = params.C @ x + LR @ zy_t
        return x, (x, y)

    _, (xs, ys) = jax.lax.scan(body, x0, (zx, zy))
    return ys, xs
