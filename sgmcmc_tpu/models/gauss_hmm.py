"""Gaussian hidden Markov model (GaussHMM).

z_t ~ Markov(pi),   y_t | z_t = k ~ N(mu_k, R_k)

Rewrite of `/root/reference/sgmcmc_ssm/models/gauss_hmm/`.  The transition
matrix is stored in the reference's 'logit' parameterization
(rows of pi are softmax(logit_pi), `variables/probweight.py:169-390`);
per-state means and covariances use the usual Cholesky-of-precision packing.
Exact discrete message passing lives in `sgmcmc_tpu.ops.hmm`.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import pytree

from ..ops import hmm
from ..utils.distributions import sample_wishart, wishart_logpdf
from ..utils.linalg import (lower_tri_mat_inv, mat_to_tril_vector,
                            pos_def_mat_inv, tril_vector_to_mat)

_LOG_2PI = float(np.log(2.0 * np.pi))


@pytree.dataclass
class GaussHMMParams:
    """GaussHMM parameter pytree ('logit' pi parameterization)."""
    logit_pi: jax.Array      # (K, K)
    mu: jax.Array            # (K, m)
    LRinv_vec: jax.Array     # (K, m(m+1)/2)

    @property
    def num_states(self):
        return self.logit_pi.shape[0]

    @property
    def m(self):
        return self.mu.shape[1]

    @property
    def pi(self):
        return jax.nn.softmax(self.logit_pi, axis=-1)

    @property
    def LRinv(self):
        return tril_vector_to_mat(self.LRinv_vec)    # (K, m, m)

    @property
    def Rinv(self):
        L = self.LRinv
        return L @ jnp.swapaxes(L, -1, -2)

    @property
    def R(self):
        return jax.vmap(pos_def_mat_inv)(self.Rinv)

    @property
    def tau(self):
        # per-state emission scale 1/diag(LRinv) — the natural trace-eval
        # coordinate, mirroring the SVM's tau alias (svm/parameters.py:42-61)
        return 1.0 / jnp.abs(
            jnp.diagonal(self.LRinv, axis1=-2, axis2=-1))


def from_values(pi, mu, R, dtype=jnp.float64) -> GaussHMMParams:
    """Host-NumPy leaves (constructors must not dispatch device ops)."""
    npdtype = np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    pi = np.asarray(pi, npdtype)
    mu = np.atleast_2d(np.asarray(mu, npdtype))
    R = np.asarray(R, npdtype)
    if R.ndim == 2:
        R = np.repeat(R[None], pi.shape[0], axis=0)
    LRinv = np.linalg.cholesky(np.linalg.inv(R))
    rows, cols = np.tril_indices(LRinv.shape[-1])
    return GaussHMMParams(
        logit_pi=np.log(pi + 1e-99),
        mu=mu,
        LRinv_vec=LRinv[:, rows, cols],
    )


def emission_logliks(params: GaussHMMParams, observations) -> jax.Array:
    """logP [T, K] = log N(y_t; mu_k, R_k) (`gauss_hmm/helper.py:127-150`)."""
    diff = observations[:, None, :] - params.mu[None, :, :]   # [T, K, m]
    LR = params.LRinv                                          # [K, m, m]
    z = jnp.einsum('tkm,kmn->tkn', diff, LR)
    half_logdet = jnp.sum(jnp.log(jnp.abs(
        jnp.diagonal(LR, axis1=-2, axis2=-1))), axis=-1)       # [K]
    return (-0.5 * params.m * _LOG_2PI + half_logdet[None, :]
            - 0.5 * jnp.sum(z * z, axis=-1))


def default_forward_message(params, dtype=None):
    return hmm.default_forward_message(params.num_states,
                                       dtype or params.mu.dtype)


def default_backward_message(params, dtype=None):
    return hmm.default_backward_message(params.num_states,
                                        dtype or params.mu.dtype)


def marginal_loglikelihood(params: GaussHMMParams, observations,
                           forward_msg=None, backward_msg=None, weights=None,
                           valid=None):
    logP = emission_logliks(params, observations)
    if forward_msg is None:
        forward_msg = default_forward_message(params)
    if backward_msg is None:
        backward_msg = default_backward_message(params)
    return hmm.marginal_loglikelihood(logP, params.pi, forward_msg,
                                      backward_msg, weights, valid)


def gradient_marginal_loglikelihood(params: GaussHMMParams, observations,
                                    forward_msg=None, backward_msg=None,
                                    weights=None, use_scir: bool = False,
                                    valid=None) -> GaussHMMParams:
    """Exact HMM gradient (`gauss_hmm/helper.py:152-228`), vectorized over t.

    With ``use_scir`` the pi-slot carries the Dirichlet sufficient
    statistic sum_t w_t joint_t instead of the logit gradient
    (`:199-201`).
    """
    T = observations.shape[0]
    dtype = observations.dtype
    if weights is None:
        weights = jnp.ones((T,), dtype)
    if forward_msg is None:
        forward_msg = default_forward_message(params)
    if backward_msg is None:
        backward_msg = default_backward_message(params)

    if valid is not None:
        weights = weights * valid
    logP = emission_logliks(params, observations)
    joint, marg = hmm.posterior_marginals(logP, params.pi, forward_msg,
                                          backward_msg, valid=valid)
    joint_sum = jnp.einsum('t,tij->ij', weights, joint)
    if use_scir:
        g_pi = joint_sum
    else:
        g_pi = hmm.grad_logit_pi(joint_sum, params.pi)

    w_marg = weights[:, None] * marg                       # [T, K]
    diff = observations[:, None, :] - params.mu[None, :, :]  # [T, K, m]
    Rinv = params.Rinv
    g_mu = jnp.einsum('kmn,tkn,tk->km', Rinv, diff, w_marg)

    R = params.R
    LR = params.LRinv
    sum_marg = jnp.sum(w_marg, axis=0)                     # [K]
    outer = jnp.einsum('tkm,tkn,tk->kmn', diff, diff, w_marg)
    g_LR = (sum_marg[:, None, None] * R - outer) @ LR
    return GaussHMMParams(
        logit_pi=g_pi, mu=g_mu,
        LRinv_vec=jax.vmap(mat_to_tril_vector)(g_LR))


def parallel_marginal_loglikelihood(params, observations,
                                    forward_msg=None, backward_msg=None):
    """O(log T)-depth full-data loglikelihood via associative prefix
    products of the per-step transition-emission matrices
    (`ops/hmm.parallel_forward_messages`)."""
    logP = emission_logliks(params, observations)
    if forward_msg is None:
        forward_msg = default_forward_message(params)
    if backward_msg is None:
        backward_msg = default_backward_message(params)
    return hmm.parallel_marginal_loglikelihood(logP, params.pi,
                                               forward_msg, backward_msg)


def predictive_loglikelihood(params, observations, lag=1, forward_msg=None):
    logP = emission_logliks(params, observations)
    if forward_msg is None:
        forward_msg = default_forward_message(params)
    return hmm.predictive_loglikelihood(logP, params.pi, forward_msg, lag)


def windowed_marginal_gradient(params: GaussHMMParams, window, valid,
                               weights, B: int, S: int,
                               use_scir: bool = False):
    """Buffered exact-gradient estimator over a [B | S | B] window with
    edge-validity masking (see `lgssm.windowed_marginal_gradient`)."""
    logP = emission_logliks(params, window)
    fwd0 = default_forward_message(params)
    bwd0 = default_backward_message(params)
    if B:
        f = hmm.forward_messages(logP[:B], params.pi, fwd0,
                                 valid=valid[:B])
        fwd = hmm.HMMMessage(f.prob[-1], f.log_constant[-1])
        b = hmm.backward_messages(logP[B + S:], params.pi, bwd0,
                                  valid=valid[B + S:])
        bwd = hmm.HMMMessage(b.prob[0], b.log_constant[0])
    else:
        fwd, bwd = fwd0, bwd0
    sub = window[B:B + S]
    v_sub = valid[B:B + S]
    grad = gradient_marginal_loglikelihood(params, sub, fwd, bwd, weights,
                                           use_scir=use_scir, valid=v_sub)
    loglik = hmm.marginal_loglikelihood(logP[B:B + S], params.pi, fwd, bwd,
                                        weights, valid=v_sub)
    return grad, loglik


def latent_var_distr(params, observations, forward_msg=None,
                     backward_msg=None, lag=None):
    logP = emission_logliks(params, observations)
    if forward_msg is None:
        forward_msg = default_forward_message(params)
    if backward_msg is None:
        backward_msg = default_backward_message(params)
    return hmm.latent_var_distr(logP, params.pi, forward_msg, backward_msg,
                                lag=lag)


def latent_var_sample(params, key, observations, forward_msg=None,
                      backward_msg=None, distr: str = "joint", lag=None,
                      num_samples: int = 1, valid=None):
    """Posterior z draws: ``distr='joint'`` FFBS paths;
    ``distr='marginal'`` independent per-t categorical draws from the
    (optionally lagged) marginals (reference `predict` contract,
    `sgmcmc_sampler.py:1025-1045`)."""
    if distr == "joint":
        if lag is not None:
            raise ValueError("Must set distr to 'marginal' for lag != None")
        logP = emission_logliks(params, observations)
        if forward_msg is None:
            forward_msg = default_forward_message(params)
        if backward_msg is None:
            backward_msg = default_backward_message(params)
        if num_samples == 1:
            return hmm.latent_var_sample(key, logP, params.pi, forward_msg,
                                         backward_msg, valid=valid)
        return jax.vmap(lambda k: hmm.latent_var_sample(
            k, logP, params.pi, forward_msg, backward_msg, valid=valid))(
            jax.random.split(key, num_samples))
    if valid is not None:
        raise ValueError("valid masking is only supported for distr='joint'")
    if distr != "marginal":
        raise ValueError(f"Unrecognized distr '{distr}'")
    probs = latent_var_distr(params, observations, forward_msg,
                             backward_msg, lag=lag)
    logits = jnp.log(probs + 1e-300)
    z = jax.vmap(lambda k: jax.vmap(jax.random.categorical)(
        jax.random.split(k, logits.shape[0]), logits))(
        jax.random.split(key, num_samples)).astype(jnp.int32)
    return z[0] if num_samples == 1 else z


def complete_data_loglikelihood(params: GaussHMMParams, observations, z,
                                z_prev=None, weights=None):
    """log p(y, z | theta) (`gauss_hmm/helper.py:230-252` semantics),
    differentiable in the parameters (one-hot emission selection, gathered
    log-transition rows)."""
    T = observations.shape[0]
    dtype = observations.dtype
    if weights is None:
        weights = jnp.ones((T,), dtype)
    logP = emission_logliks(params, observations)              # [T, K]
    onehot = jax.nn.one_hot(z, params.num_states, dtype=dtype)
    total = jnp.sum(weights * jnp.sum(onehot * logP, axis=-1))
    log_pi = jnp.log(params.pi + 1e-32)
    total += jnp.sum(weights[1:] * log_pi[z[:-1], z[1:]])
    if z_prev is not None:
        total += weights[0] * log_pi[z_prev, z[0]]
    return total


def windowed_complete_gradient(params: GaussHMMParams, window, valid,
                               weights, B: int, S: int, key,
                               num_samples: int = 1):
    """kind='complete' buffered estimator: FFBS z draws over the window,
    then the weighted complete-data score over the subsequence
    (`_single_noisy_grad_loglikelihood` kind='complete',
    `sgmcmc_sampler.py:330-362`).  Score = autodiff of the complete-data
    loglikelihood (logit_pi gradient flows through the softmax)."""
    # Deliberate delta from the reference (`sgmcmc_sampler.py:330-362`
    # drops the first transition term at the sequence start): the
    # pre-window state is completed exactly — z_prev | z_first ~
    # p0[i] * Pi[i, z_first] — so E[grad complete] = grad marginal holds
    # exactly at edge windows too (`tests/test_valid_ffbs.py`).
    p0 = default_forward_message(params).prob

    def one_sample(k):
        k_ffbs, k_prev = jax.random.split(k)
        z = latent_var_sample(params, k_ffbs, window, valid=valid)
        z = jax.lax.stop_gradient(z)
        logit_init = jnp.log(p0 * params.pi[:, z[B]] + 1e-300)
        z_init = jax.random.categorical(k_prev, logit_init).astype(jnp.int32)
        z_init = jax.lax.stop_gradient(z_init)
        if B > 0:
            z_prev = jnp.where(valid[B - 1] > 0, z[B - 1], z_init)
        else:
            z_prev = z_init

        def cdl(p):
            return complete_data_loglikelihood(
                p, window[B:B + S], z[B:B + S], z_prev=z_prev,
                weights=weights)

        return jax.grad(cdl)(params), cdl(params)

    grads, lls = jax.vmap(one_sample)(jax.random.split(key, num_samples))
    grad = jax.tree_util.tree_map(lambda g: jnp.mean(g, axis=0), grads)
    return grad, jnp.mean(lls)


# --------------------------------------------------------------------------
# Prior (`gauss_hmm/parameters.py:37-48`): Dirichlet(pi rows),
# Wishart(Rinv_k), Normal(mu_k | R_k)
# --------------------------------------------------------------------------

@pytree.dataclass
class GaussHMMPrior:
    alpha_pi: jax.Array      # (K, K)
    mean_mu: jax.Array       # (K, m)
    var_col_mu: jax.Array    # (K,)
    scale_Rinv: jax.Array    # (K, m, m)
    df_Rinv: jax.Array       # ()


def default_prior(num_states: int, m: int = 1, var: float = 100.0,
                  dtype=jnp.float64) -> GaussHMMPrior:
    """Host-NumPy leaves (no eager device dispatch)."""
    npdtype = np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    df = m + 1.0 + 1.0 / var
    return GaussHMMPrior(
        alpha_pi=np.full((num_states, num_states), 1.0 / var, npdtype),
        mean_mu=np.zeros((num_states, m), npdtype),
        var_col_mu=np.full((num_states,), var, npdtype),
        scale_Rinv=np.tile(np.eye(m, dtype=npdtype) / df,
                           (num_states, 1, 1)),
        df_Rinv=np.asarray(df, npdtype),
    )


def logprior(prior: GaussHMMPrior, params: GaussHMMParams) -> jax.Array:
    pi = params.pi
    a = prior.alpha_pi
    lp = jnp.sum((a - 1.0) * jnp.log(pi + 1e-16))
    lp += jnp.sum(jax.scipy.special.gammaln(jnp.sum(a, -1))
                  - jnp.sum(jax.scipy.special.gammaln(a), -1))
    Rinv = params.Rinv
    lp += jnp.sum(jax.vmap(wishart_logpdf, in_axes=(0, None, 0))(
        Rinv, prior.df_Rinv, prior.scale_Rinv))
    # mu_k | R_k ~ N(mean, R_k * var_col)
    diff = params.mu - prior.mean_mu
    quad = jnp.einsum('km,kmn,kn->k', diff, Rinv, diff) / prior.var_col_mu
    LR = params.LRinv
    half_logdet = jnp.sum(jnp.log(jnp.abs(
        jnp.diagonal(LR, axis1=-2, axis2=-1))), axis=-1)
    lp += jnp.sum(-0.5 * params.m * _LOG_2PI + half_logdet
                  - 0.5 * params.m * jnp.log(prior.var_col_mu) - 0.5 * quad)
    return lp


def grad_logprior(prior: GaussHMMPrior, params: GaussHMMParams,
                  use_scir: bool = False) -> GaussHMMParams:
    """Reference semantics: mu-prior treats R as constant; pi prior in
    logit coordinates (`probweight.py:448-462`, `matrices.py:414-446`,
    `covariance.py:252-260`)."""
    if use_scir:
        g_pi = prior.alpha_pi
    else:
        g_pi = hmm.dirichlet_grad_logit_pi(prior.alpha_pi, params.pi)
    Rinv = params.Rinv
    g_mu = -jnp.einsum('kmn,kn->km', Rinv, params.mu - prior.mean_mu
                       ) / prior.var_col_mu[:, None]
    m = params.m

    def cov_grad(LR_k, scale_k):
        return ((prior.df_Rinv - m - 1) * lower_tri_mat_inv(LR_k).T
                - jnp.linalg.solve(scale_k, LR_k))

    g_LR = jax.vmap(cov_grad)(params.LRinv, prior.scale_Rinv)
    return GaussHMMParams(logit_pi=g_pi, mu=g_mu,
                          LRinv_vec=jax.vmap(mat_to_tril_vector)(g_LR))


def sample_prior(prior: GaussHMMPrior, key) -> GaussHMMParams:
    K, m = prior.mean_mu.shape
    dtype = prior.mean_mu.dtype
    kp, kr, km = jax.random.split(key, 3)
    # Dirichlet rows via gammas
    g = jax.random.gamma(kp, prior.alpha_pi, dtype=dtype)
    pi = g / jnp.sum(g, axis=-1, keepdims=True)
    Rinv = jax.vmap(sample_wishart, in_axes=(0, None, 0))(
        jax.random.split(kr, K), prior.df_Rinv, prior.scale_Rinv)
    LRinv = jnp.linalg.cholesky(Rinv)
    z = jax.random.normal(km, (K, m), dtype)
    # mu_k | R_k ~ N(mean, var_col * R_k): R_k^(1/2) z = solve(LRinv^T, z)
    noise = jax.vmap(lambda L, zz: jax.scipy.linalg.solve_triangular(
        L.T, zz, lower=False))(LRinv, z)
    mu = prior.mean_mu + jnp.sqrt(prior.var_col_mu)[:, None] * noise
    return GaussHMMParams(logit_pi=jnp.log(pi + 1e-99), mu=mu,
                          LRinv_vec=jax.vmap(mat_to_tril_vector)(LRinv))


def project_parameters(params: GaussHMMParams,
                       center_logit: bool = True) -> GaussHMMParams:
    """Center logits for stability (`probweight.py:206-214`), reflect
    Cholesky diagonals."""
    logit_pi = params.logit_pi
    if center_logit:
        logit_pi = logit_pi - jnp.mean(logit_pi, axis=1, keepdims=True)
    LR = params.LRinv
    idx = jnp.arange(LR.shape[-1])
    LR = LR.at[:, idx, idx].set(jnp.abs(LR[:, idx, idx]))
    return GaussHMMParams(logit_pi=logit_pi, mu=params.mu,
                          LRinv_vec=jax.vmap(mat_to_tril_vector)(LR))


# --------------------------------------------------------------------------
# SGRLD preconditioner (`gauss_hmm/parameters.py:49-58`)
# --------------------------------------------------------------------------

def precondition(params: GaussHMMParams, grad: GaussHMMParams
                 ) -> GaussHMMParams:
    R = params.R
    Rinv = params.Rinv
    g_LR = tril_vector_to_mat(grad.LRinv_vec)
    return GaussHMMParams(
        logit_pi=grad.logit_pi,
        mu=jnp.einsum('kmn,kn->km', R, grad.mu),
        LRinv_vec=jax.vmap(mat_to_tril_vector)(0.5 * Rinv @ g_LR),
    )


def precondition_noise(params: GaussHMMParams, key) -> GaussHMMParams:
    K, m = params.mu.shape
    dtype = params.mu.dtype
    kp, km, kr = jax.random.split(key, 3)
    LR = params.LRinv
    z_mu = jax.random.normal(km, (K, m), dtype)
    noise_mu = jax.vmap(lambda L, z: jax.scipy.linalg.solve_triangular(
        L.T, z, lower=False))(LR, z_mu)
    z_R = jax.random.normal(kr, (K, m, m), dtype)
    noise_LR = jnp.sqrt(0.5) * LR @ z_R
    return GaussHMMParams(
        logit_pi=jax.random.normal(kp, params.logit_pi.shape, dtype),
        mu=noise_mu,
        LRinv_vec=jax.vmap(mat_to_tril_vector)(noise_LR),
    )


def correction_term(params: GaussHMMParams) -> GaussHMMParams:
    m = params.m
    return GaussHMMParams(
        logit_pi=jnp.zeros_like(params.logit_pi),
        mu=jnp.zeros_like(params.mu),
        LRinv_vec=0.5 * (m + 1) * params.LRinv_vec,
    )


# --------------------------------------------------------------------------
# SCIR transition update (CIRSamplerMixin, `hmm_helper.py:396-566`)
# --------------------------------------------------------------------------

def scir_transition_update(key, params: GaussHMMParams, a: jax.Array,
                           epsilon: float) -> jax.Array:
    """One SCIR step on the transition simplex in logit storage:
    theta = exp(centered logit) rows; returns new centered logit_pi."""
    theta = jnp.exp(params.logit_pi)
    theta_new = hmm.scir_update(key, theta, a, epsilon)
    logit = jnp.log(jnp.abs(theta_new) + 1e-99)
    return logit - jnp.mean(logit, axis=1, keepdims=True)


# --------------------------------------------------------------------------
# Gibbs (`gauss_hmm/helper.py:77-126`, conjugate updates)
# --------------------------------------------------------------------------

def gibbs_parameters_sample(key, prior: GaussHMMPrior, observations, z
                            ) -> GaussHMMParams:
    """theta | z, y: Dirichlet posterior on pi rows, normal-Wishart on
    (mu_k, Rinv_k)."""
    K, m = prior.mean_mu.shape
    dtype = observations.dtype
    kp, kr, km = jax.random.split(key, 3)

    # transition counts
    zo = jax.nn.one_hot(z, K, dtype=dtype)
    counts = jnp.einsum('ti,tj->ij', zo[:-1], zo[1:])
    g = jax.random.gamma(kp, prior.alpha_pi + counts, dtype=dtype)
    pi = g / jnp.sum(g, axis=-1, keepdims=True)

    # per-state sufficient stats
    n_k = jnp.sum(zo, axis=0)                               # [K]
    sum_y = jnp.einsum('tk,tm->km', zo, observations)
    sum_yy = jnp.einsum('tk,tm,tn->kmn', zo, observations, observations)

    prec0 = 1.0 / prior.var_col_mu                          # [K]
    Spp = prec0 + n_k
    Scp = prior.mean_mu * prec0[:, None] + sum_y            # [K, m]
    Scc = (jnp.einsum('km,kn->kmn', prior.mean_mu,
                      prior.mean_mu * prec0[:, None]) + sum_yy)
    mu_post = Scp / Spp[:, None]
    S_schur = Scc - jnp.einsum('km,kn->kmn', Scp, Scp) / Spp[:, None, None]
    df_post = prior.df_Rinv + n_k
    scale_post = jnp.linalg.inv(jnp.linalg.inv(prior.scale_Rinv) + S_schur)

    Rinv = jax.vmap(sample_wishart)(jax.random.split(kr, K), df_post,
                                    scale_post)
    LRinv = jnp.linalg.cholesky(Rinv)
    z_mu = jax.random.normal(km, (K, m), dtype)
    noise = jax.vmap(lambda L, zz: jax.scipy.linalg.solve_triangular(
        L.T, zz, lower=False))(LRinv, z_mu) / jnp.sqrt(Spp)[:, None]
    mu = mu_post + noise
    return GaussHMMParams(logit_pi=jnp.log(pi + 1e-99), mu=mu,
                          LRinv_vec=jax.vmap(mat_to_tril_vector)(LRinv))


def gibbs_step(key, prior, params, observations):
    kz, kp = jax.random.split(key)
    z = latent_var_sample(params, kz, observations)
    return gibbs_parameters_sample(kp, prior, observations, z)


# --------------------------------------------------------------------------
# Data generation (`gauss_hmm/parameters.py:60-...`)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("T",))
def generate_data(key, params: GaussHMMParams, T: int):
    params = jax.tree_util.tree_map(jnp.asarray, params)
    K, m = params.mu.shape
    dtype = params.mu.dtype
    kz, ky, k0 = jax.random.split(key, 3)
    LR_chol = jnp.linalg.cholesky(params.R)     # [K, m, m]
    z_keys = jax.random.split(kz, T)
    noise = jax.random.normal(ky, (T, m), dtype)
    log_pi = jnp.log(params.pi + 1e-99)

    z0 = jax.random.categorical(k0, jnp.zeros((K,), dtype))

    def body(z_prev, inp):
        k, eps = inp
        z = jax.random.categorical(k, log_pi[z_prev])
        y = params.mu[z] + LR_chol[z] @ eps
        return z, (z, y)

    _, (zs, ys) = jax.lax.scan(body, z0, (z_keys, noise))
    return ys, zs
