"""AR(p) hidden Markov model (ARPHMM).

z_t ~ Markov(pi),   y_t | z_t = k ~ N(D_k [y_{t-1}; ...; y_{t-p}], R_k)

Rewrite of `/root/reference/sgmcmc_ssm/models/arphmm/`.  Observations are
lag-stacked ([T, p+1, m] with slot 0 the current y — `stack_y`,
`arphmm/parameters.py:132-151`); exact discrete messages come from
`sgmcmc_tpu.ops.hmm` and the emission machinery mirrors
`arphmm/helper.py:231-334`.
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
class ARPHMMParams:
    """ARPHMM parameter pytree ('logit' pi parameterization)."""
    logit_pi: jax.Array      # (K, K)
    D: jax.Array             # (K, m, d) with d = m * p
    LRinv_vec: jax.Array     # (K, m(m+1)/2)

    @property
    def num_states(self):
        return self.logit_pi.shape[0]

    @property
    def m(self):
        return self.D.shape[1]

    @property
    def d(self):
        return self.D.shape[2]

    @property
    def p(self):
        return self.d // self.m

    @property
    def pi(self):
        return jax.nn.softmax(self.logit_pi, axis=-1)

    @property
    def LRinv(self):
        return tril_vector_to_mat(self.LRinv_vec)

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


def from_values(pi, D, R, dtype=jnp.float64) -> ARPHMMParams:
    """Host-NumPy leaves (constructors must not dispatch device ops)."""
    npdtype = np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    pi = np.asarray(pi, npdtype)
    D = np.asarray(D, npdtype)
    R = np.asarray(R, npdtype)
    if R.ndim == 2:
        R = np.repeat(R[None], pi.shape[0], axis=0)
    LRinv = np.linalg.cholesky(np.linalg.inv(R))
    rows, cols = np.tril_indices(LRinv.shape[-1])
    return ARPHMMParams(logit_pi=np.log(pi + 1e-99), D=D,
                        LRinv_vec=LRinv[:, rows, cols])


def stack_y(y: jax.Array, p: int) -> jax.Array:
    """[T+p, m] -> [T, p+1, m]: slot l of row t is y[p + t - l]
    (`arphmm/parameters.py:132-151`)."""
    y = jnp.atleast_2d(y.T).T if y.ndim == 1 else y
    T = y.shape[0] - p
    lags = [y[p - l:p - l + T] for l in range(p + 1)]
    return jnp.stack(lags, axis=1)


def emission_logliks(params: ARPHMMParams, observations) -> jax.Array:
    """logP [T, K] for lag-stacked observations [T, p+1, m]."""
    y0 = observations[:, 0, :]                               # [T, m]
    y_prev = observations[:, 1:, :].reshape(observations.shape[0], -1)
    mean = jnp.einsum('kmd,td->tkm', params.D, y_prev)       # [T, K, m]
    diff = y0[:, None, :] - mean
    LR = params.LRinv
    z = jnp.einsum('tkm,kmn->tkn', diff, LR)
    half_logdet = jnp.sum(jnp.log(jnp.abs(
        jnp.diagonal(LR, axis1=-2, axis2=-1))), axis=-1)
    return (-0.5 * params.m * _LOG_2PI + half_logdet[None, :]
            - 0.5 * jnp.sum(z * z, axis=-1))


def default_forward_message(params, dtype=None):
    return hmm.default_forward_message(params.num_states,
                                       dtype or params.D.dtype)


def default_backward_message(params, dtype=None):
    return hmm.default_backward_message(params.num_states,
                                        dtype or params.D.dtype)


def marginal_loglikelihood(params, observations, forward_msg=None,
                           backward_msg=None, weights=None, valid=None):
    logP = emission_logliks(params, observations)
    if forward_msg is None:
        forward_msg = default_forward_message(params)
    if backward_msg is None:
        backward_msg = default_backward_message(params)
    return hmm.marginal_loglikelihood(logP, params.pi, forward_msg,
                                      backward_msg, weights, valid)


def gradient_marginal_loglikelihood(params, observations, forward_msg=None,
                                    backward_msg=None, weights=None,
                                    use_scir: bool = False,
                                    valid=None) -> ARPHMMParams:
    """Exact gradient (`arphmm/helper.py:258-334`), vectorized over t."""
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
    g_pi = joint_sum if use_scir else hmm.grad_logit_pi(joint_sum, params.pi)

    w_marg = weights[:, None] * marg
    y0 = observations[:, 0, :]
    y_prev = observations[:, 1:, :].reshape(T, -1)
    mean = jnp.einsum('kmd,td->tkm', params.D, y_prev)
    diff = y0[:, None, :] - mean                             # [T, K, m]
    Rinv = params.Rinv
    g_D = jnp.einsum('kmn,tkn,td,tk->kmd', Rinv, diff, y_prev, w_marg)

    R, LR = params.R, params.LRinv
    sum_marg = jnp.sum(w_marg, axis=0)
    outer = jnp.einsum('tkm,tkn,tk->kmn', diff, diff, w_marg)
    g_LR = (sum_marg[:, None, None] * R - outer) @ LR
    return ARPHMMParams(logit_pi=g_pi, D=g_D,
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


def windowed_marginal_gradient(params: ARPHMMParams, window, valid,
                               weights, B: int, S: int,
                               use_scir: bool = False):
    """Buffered exact-gradient estimator over a [B | S | B] window with
    edge-validity masking (see `lgssm.windowed_marginal_gradient`)."""
    logP = emission_logliks(params, window)
    fwd0 = default_forward_message(params)
    bwd0 = default_backward_message(params)
    if B:
        f = hmm.forward_messages(logP[:B], params.pi, fwd0, valid=valid[:B])
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


def complete_data_loglikelihood(params: ARPHMMParams, observations, z,
                                z_prev=None, weights=None):
    """log p(y, z | theta) for lag-stacked observations [T, p+1, m],
    differentiable in the parameters (see
    `gauss_hmm.complete_data_loglikelihood`)."""
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


def windowed_complete_gradient(params: ARPHMMParams, window, valid,
                               weights, B: int, S: int, key,
                               num_samples: int = 1):
    """kind='complete' buffered estimator (FFBS z draw + weighted
    complete-data autodiff score; `sgmcmc_sampler.py:330-362`)."""
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
# Prior / projection / preconditioner (same helper structure as GaussHMM)
# --------------------------------------------------------------------------

@pytree.dataclass
class ARPHMMPrior:
    alpha_pi: jax.Array      # (K, K)
    mean_D: jax.Array        # (K, m, d)
    var_col_D: jax.Array     # (K, d)
    scale_Rinv: jax.Array    # (K, m, m)
    df_Rinv: jax.Array       # ()


def default_prior(num_states: int, m: int, d: int, var: float = 100.0,
                  dtype=jnp.float64) -> ARPHMMPrior:
    """Host-NumPy leaves (no eager device dispatch)."""
    npdtype = np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    df = m + 1.0 + 1.0 / var
    return ARPHMMPrior(
        alpha_pi=np.full((num_states, num_states), 1.0 / var, npdtype),
        mean_D=np.zeros((num_states, m, d), npdtype),
        var_col_D=np.full((num_states, d), var, npdtype),
        scale_Rinv=np.tile(np.eye(m, dtype=npdtype) / df,
                           (num_states, 1, 1)),
        df_Rinv=np.asarray(df, npdtype),
    )


def logprior(prior: ARPHMMPrior, params: ARPHMMParams) -> jax.Array:
    pi = params.pi
    a = prior.alpha_pi
    lp = jnp.sum((a - 1.0) * jnp.log(pi + 1e-16))
    lp += jnp.sum(jax.scipy.special.gammaln(jnp.sum(a, -1))
                  - jnp.sum(jax.scipy.special.gammaln(a), -1))
    lp += jnp.sum(jax.vmap(wishart_logpdf, in_axes=(0, None, 0))(
        params.Rinv, prior.df_Rinv, prior.scale_Rinv))
    diff = params.D - prior.mean_D
    Rinv = params.Rinv
    quad = jnp.einsum('kmd,kmn,knd,kd->', diff, Rinv, diff,
                      1.0 / prior.var_col_D)
    LR = params.LRinv
    half_logdet = jnp.sum(jnp.log(jnp.abs(
        jnp.diagonal(LR, axis1=-2, axis2=-1))), axis=-1)
    d = params.d
    lp += jnp.sum(d * half_logdet
                  - 0.5 * params.m * jnp.sum(jnp.log(prior.var_col_D), -1)
                  - 0.5 * params.m * d * _LOG_2PI / params.m) - 0.5 * quad
    return lp


def grad_logprior(prior: ARPHMMPrior, params: ARPHMMParams,
                  use_scir: bool = False) -> ARPHMMParams:
    g_pi = prior.alpha_pi if use_scir else hmm.dirichlet_grad_logit_pi(
        prior.alpha_pi, params.pi)
    Rinv = params.Rinv
    g_D = -jnp.einsum('kmn,knd->kmd', Rinv, params.D - prior.mean_D
                      ) / prior.var_col_D[:, None, :]
    m = params.m

    def cov_grad(LR_k, scale_k):
        return ((prior.df_Rinv - m - 1) * lower_tri_mat_inv(LR_k).T
                - jnp.linalg.solve(scale_k, LR_k))

    g_LR = jax.vmap(cov_grad)(params.LRinv, prior.scale_Rinv)
    return ARPHMMParams(logit_pi=g_pi, D=g_D,
                        LRinv_vec=jax.vmap(mat_to_tril_vector)(g_LR))


def sample_prior(prior: ARPHMMPrior, key) -> ARPHMMParams:
    K, m, d = prior.mean_D.shape
    dtype = prior.mean_D.dtype
    kp, kr, kd = jax.random.split(key, 3)
    g = jax.random.gamma(kp, prior.alpha_pi, dtype=dtype)
    pi = g / jnp.sum(g, axis=-1, keepdims=True)
    Rinv = jax.vmap(sample_wishart, in_axes=(0, None, 0))(
        jax.random.split(kr, K), prior.df_Rinv, prior.scale_Rinv)
    LRinv = jnp.linalg.cholesky(Rinv)
    z = jax.random.normal(kd, (K, m, d), dtype)
    noise = jax.vmap(lambda L, zz: jax.scipy.linalg.solve_triangular(
        L.T, zz, lower=False))(LRinv, z)
    D = prior.mean_D + noise * jnp.sqrt(prior.var_col_D)[:, None, :]
    return ARPHMMParams(logit_pi=jnp.log(pi + 1e-99), D=D,
                        LRinv_vec=jax.vmap(mat_to_tril_vector)(LRinv))


def project_parameters(params: ARPHMMParams, d_threshold: float = 0.9999,
                       center_logit: bool = True) -> ARPHMMParams:
    from ..utils.linalg import spectral_norm_projection
    logit_pi = params.logit_pi
    if center_logit:
        logit_pi = logit_pi - jnp.mean(logit_pi, axis=1, keepdims=True)
    D = jax.vmap(lambda Dk: spectral_norm_projection(Dk, d_threshold))(
        params.D)
    LR = params.LRinv
    idx = jnp.arange(LR.shape[-1])
    LR = LR.at[:, idx, idx].set(jnp.abs(LR[:, idx, idx]))
    return ARPHMMParams(logit_pi=logit_pi, D=D,
                        LRinv_vec=jax.vmap(mat_to_tril_vector)(LR))


def precondition(params: ARPHMMParams, grad: ARPHMMParams) -> ARPHMMParams:
    R, Rinv = params.R, params.Rinv
    g_LR = tril_vector_to_mat(grad.LRinv_vec)
    return ARPHMMParams(
        logit_pi=grad.logit_pi,
        D=jnp.einsum('kmn,knd->kmd', R, grad.D),
        LRinv_vec=jax.vmap(mat_to_tril_vector)(0.5 * Rinv @ g_LR),
    )


def precondition_noise(params: ARPHMMParams, key) -> ARPHMMParams:
    K, m, d = params.D.shape
    dtype = params.D.dtype
    kp, kd, kr = jax.random.split(key, 3)
    LR = params.LRinv
    z_D = jax.random.normal(kd, (K, m, d), dtype)
    noise_D = jax.vmap(lambda L, z: jax.scipy.linalg.solve_triangular(
        L.T, z, lower=False))(LR, z_D)
    z_R = jax.random.normal(kr, (K, m, m), dtype)
    return ARPHMMParams(
        logit_pi=jax.random.normal(kp, params.logit_pi.shape, dtype),
        D=noise_D,
        LRinv_vec=jax.vmap(mat_to_tril_vector)(jnp.sqrt(0.5) * LR @ z_R),
    )


def correction_term(params: ARPHMMParams) -> ARPHMMParams:
    m = params.m
    return ARPHMMParams(
        logit_pi=jnp.zeros_like(params.logit_pi),
        D=jnp.zeros_like(params.D),
        LRinv_vec=0.5 * (m + 1) * params.LRinv_vec,
    )


# --------------------------------------------------------------------------
# Blocked Gibbs (`arphmm/sampler.py:216-231`, suff stats
# `arphmm/helper.py:172-228`, conjugate draws `variables/matrices.py:1199`
# + `variables/covariance.py:207` + `variables/probweight.py:392`)
# --------------------------------------------------------------------------

def gibbs_parameters_sample(key, prior: ARPHMMPrior, observations, z
                            ) -> ARPHMMParams:
    """theta | z, y: Dirichlet posterior on pi rows and per-state
    matrix-normal-Wishart posterior on (D_k, Rinv_k).

    One-hot einsum contractions replace the reference's per-state boolean
    indexing (`calc_gibbs_sufficient_statistic`, `arphmm/helper.py:172`),
    so the whole update is one fixed-shape jitted program.
    """
    K, m, d = prior.mean_D.shape
    dtype = observations.dtype
    kp, kr, kd = jax.random.split(key, 3)

    # transition counts -> Dirichlet rows
    zo = jax.nn.one_hot(z, K, dtype=dtype)                   # [T, K]
    counts = jnp.einsum('ti,tj->ij', zo[:-1], zo[1:])
    g = jax.random.gamma(kp, prior.alpha_pi + counts, dtype=dtype)
    pi = g / jnp.sum(g, axis=-1, keepdims=True)

    # per-state regression sufficient statistics
    y0 = observations[:, 0, :]                               # [T, m]
    y_prev = observations[:, 1:, :].reshape(observations.shape[0], -1)
    n_k = jnp.sum(zo, axis=0)                                # [K]
    prec0 = 1.0 / prior.var_col_D                            # [K, d]
    Spp = (jnp.einsum('tk,td,te->kde', zo, y_prev, y_prev)
           + jax.vmap(jnp.diag)(prec0))                      # [K, d, d]
    Scp = (jnp.einsum('tk,tm,td->kmd', zo, y0, y_prev)
           + prior.mean_D * prec0[:, None, :])               # [K, m, d]
    Scc = (jnp.einsum('tk,tm,tn->kmn', zo, y0, y0)
           + jnp.einsum('kmd,kd,knd->kmn', prior.mean_D, prec0,
                        prior.mean_D))                       # [K, m, m]

    Lpp = jnp.linalg.cholesky(Spp)                           # [K, d, d]
    # D_post = Scp Spp^-1 via two triangular solves
    def _post_mean(Lpp_k, Scp_k):
        w = jax.scipy.linalg.solve_triangular(Lpp_k, Scp_k.T, lower=True)
        return jax.scipy.linalg.solve_triangular(Lpp_k.T, w, lower=False).T

    D_post = jax.vmap(_post_mean)(Lpp, Scp)                  # [K, m, d]
    Schur = Scc - jnp.einsum('kmd,knd->kmn', D_post, Scp)
    Schur = 0.5 * (Schur + jnp.swapaxes(Schur, -1, -2))

    df_post = prior.df_Rinv + n_k
    scale_post = jnp.linalg.inv(jnp.linalg.inv(prior.scale_Rinv) + Schur)
    Rinv = jax.vmap(sample_wishart)(jax.random.split(kr, K), df_post,
                                    scale_post)              # [K, m, m]
    LRinv = jnp.linalg.cholesky(Rinv)

    # D | R ~ MN(D_post, row cov R, col cov Spp^-1)
    zD = jax.random.normal(kd, (K, m, d), dtype)

    def _mn_noise(LRinv_k, Lpp_k, z_k):
        a = jax.scipy.linalg.solve_triangular(LRinv_k.T, z_k, lower=False)
        return jax.scipy.linalg.solve_triangular(
            Lpp_k.T, a.T, lower=False).T

    D = D_post + jax.vmap(_mn_noise)(LRinv, Lpp, zD)
    return ARPHMMParams(logit_pi=jnp.log(pi + 1e-99), D=D,
                        LRinv_vec=jax.vmap(mat_to_tril_vector)(LRinv))


def gibbs_step(key, prior, params, observations):
    kz, kp = jax.random.split(key)
    z = latent_var_sample(params, kz, observations)
    return gibbs_parameters_sample(kp, prior, observations, z)


# --------------------------------------------------------------------------
# Data generation
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("T",))
def generate_data(key, params: ARPHMMParams, T: int):
    """Simulate; returns lag-stacked observations [T, p+1, m] and z [T]."""
    params = jax.tree_util.tree_map(jnp.asarray, params)
    K, m, d = params.D.shape
    p = params.p
    dtype = params.D.dtype
    kz, ky, k0 = jax.random.split(key, 3)
    LR_chol = jnp.linalg.cholesky(params.R)
    z_keys = jax.random.split(kz, T + p)
    noise = jax.random.normal(ky, (T + p, m), dtype)
    log_pi = jnp.log(params.pi + 1e-99)
    z0 = jax.random.categorical(k0, jnp.zeros((K,), dtype))

    def body(carry, inp):
        z_prev, y_hist = carry          # y_hist [p, m], newest first
        k, eps = inp
        z = jax.random.categorical(k, log_pi[z_prev])
        y = params.D[z] @ y_hist.reshape(-1) + LR_chol[z] @ eps
        y_hist = jnp.concatenate([y[None], y_hist[:-1]], axis=0)
        return (z, y_hist), (z, y)

    init_hist = jnp.zeros((p, m), dtype)
    _, (zs, ys) = jax.lax.scan(body, (z0, init_hist), (z_keys, noise))
    return stack_y(ys, p), zs[p:]
