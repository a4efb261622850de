"""Switching linear dynamical system (SLDS).

z_t ~ Markov(pi),  x_t = A_{z_t} x_{t-1} + N(0, Q_{z_t}),
y_t = C x_t + N(0, R)

Rewrite of `/root/reference/sgmcmc_ssm/models/slds/` (the richest non-PF
model): *conditional* message passing — x-messages given z (a time-varying
information-form Kalman scan over gathered per-state matrices), z-messages
given x (discrete messages whose emissions are the Gaussian transition
likelihoods), blocked Gibbs over (x, z, theta), and complete-data
likelihood/gradient.  As in the reference, the *joint* marginal likelihood
raises unless one latent is supplied (`slds/helper.py:1188-1254`).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import pytree

from ..ops import hmm
from ..utils.distributions import sample_wishart, wishart_logpdf
from ..utils.linalg import (mat_to_tril_vector, pos_def_mat_inv,
                            tril_vector_to_mat)

_LOG_2PI = float(np.log(2.0 * np.pi))


@pytree.dataclass
class SLDSParams:
    """SLDS parameter pytree (`slds/parameters.py:26-50`)."""
    logit_pi: jax.Array       # (K, K)
    A: jax.Array              # (K, n, n)
    LQinv_vec: jax.Array      # (K, n(n+1)/2)
    C: jax.Array              # (m, n)
    LRinv_vec: jax.Array      # (m(m+1)/2,)

    @property
    def num_states(self):
        return self.logit_pi.shape[0]

    @property
    def n(self):
        return self.A.shape[1]

    @property
    def m(self):
        return self.C.shape[0]

    @property
    def pi(self):
        return jax.nn.softmax(self.logit_pi, axis=-1)

    @property
    def LQinv(self):
        return tril_vector_to_mat(self.LQinv_vec)    # (K, n, n)

    @property
    def Qinv(self):
        L = self.LQinv
        return L @ jnp.swapaxes(L, -1, -2)

    @property
    def Q(self):
        return jax.vmap(pos_def_mat_inv)(self.Qinv)

    @property
    def LRinv(self):
        return tril_vector_to_mat(self.LRinv_vec)

    @property
    def Rinv(self):
        L = self.LRinv
        return L @ L.T

    @property
    def R(self):
        return pos_def_mat_inv(self.Rinv)

    @property
    def sigma(self):
        # per-state latent scale 1/diag(LQinv) (natural trace-eval coord,
        # mirroring the SVM sigma alias `svm/parameters.py:42-61`)
        return 1.0 / jnp.abs(
            jnp.diagonal(self.LQinv, axis1=-2, axis2=-1))

    @property
    def tau(self):
        # emission scale 1/diag(LRinv)
        return 1.0 / jnp.abs(jnp.diagonal(self.LRinv))


def from_values(pi, A, Q, C, R, dtype=jnp.float64) -> SLDSParams:
    """Host-NumPy leaves (constructors must not dispatch device ops)."""
    npdtype = np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    A = np.asarray(A, npdtype)
    Q = np.asarray(Q, npdtype)
    LQinv = np.linalg.cholesky(np.linalg.inv(Q))
    LRinv = np.linalg.cholesky(np.linalg.inv(np.atleast_2d(
        np.asarray(R, npdtype))))
    rows_q, cols_q = np.tril_indices(LQinv.shape[-1])
    rows_r, cols_r = np.tril_indices(LRinv.shape[-1])
    return SLDSParams(
        logit_pi=np.log(np.asarray(pi, npdtype) + 1e-99),
        A=A,
        LQinv_vec=LQinv[:, rows_q, cols_q],
        C=np.atleast_2d(np.asarray(C, npdtype)),
        LRinv_vec=LRinv[rows_r, cols_r],
    )


# --------------------------------------------------------------------------
# x | z: time-varying information-form Kalman (`slds/helper.py:122-291`)
# --------------------------------------------------------------------------

def _x_step_mats(params: SLDSParams, z):
    """Gather per-step transition matrices along the z path."""
    A_t = params.A[z]                                  # [T, n, n]
    Qinv_t = params.Qinv[z]                            # [T, n, n]
    AtQinv_t = jnp.swapaxes(A_t, -1, -2) @ Qinv_t
    AtQinvA_t = AtQinv_t @ A_t
    return A_t, Qinv_t, AtQinv_t, AtQinvA_t


def x_forward_messages(params: SLDSParams, observations, z,
                       init_h=None, init_J=None):
    """Filtered messages p(x_t | y_{<=t}, z) as (log_cs, hs, Js)."""
    T = observations.shape[0]
    n, m = params.n, params.m
    dtype = observations.dtype
    Rinv = params.Rinv
    C = params.C
    CtRinv = C.T @ Rinv
    CtRinvC = CtRinv @ C
    if init_h is None:
        init_h = jnp.zeros((n,), dtype)
    if init_J is None:
        init_J = jnp.eye(n, dtype=dtype) * 0.1
    _, Qinv_t, AtQinv_t, AtQinvA_t = _x_step_mats(params, z)

    def step(carry, inp):
        h, J = carry
        y, Qinv, AtQinv, AtQinvA = inp
        K = jnp.linalg.solve(AtQinvA + J, AtQinv)
        h_pred = K.T @ h
        J_pred = Qinv - AtQinv.T @ K
        y_mean = C @ jnp.linalg.solve(J_pred, h_pred)
        y_prec = Rinv - CtRinv.T @ jnp.linalg.solve(CtRinvC + J_pred, CtRinv)
        diff = y - y_mean
        log_c = (-0.5 * diff @ (y_prec @ diff)
                 + 0.5 * jnp.linalg.slogdet(y_prec)[1]
                 - 0.5 * m * _LOG_2PI)
        h_new = h_pred + CtRinv @ y
        J_new = J_pred + CtRinvC
        return (h_new, J_new), (log_c, h_new, J_new)

    (_, _), (log_cs, hs, Js) = jax.lax.scan(
        step, (init_h, init_J),
        (observations, Qinv_t, AtQinv_t, AtQinvA_t))
    return log_cs, hs, Js


def x_marginal_loglikelihood(params: SLDSParams, observations, z):
    """log p(y | z, theta) (`slds/helper.py:292-334`)."""
    log_cs, _, _ = x_forward_messages(params, observations, z)
    return jnp.sum(log_cs)


def x_latent_var_sample(params: SLDSParams, key, observations, z):
    """FFBS sample of x | y, z (`slds/helper.py:520-644`)."""
    T = observations.shape[0]
    n = params.n
    dtype = observations.dtype
    _, hs, Js = x_forward_messages(params, observations, z)
    A_t, Qinv_t, AtQinv_t, AtQinvA_t = _x_step_mats(params, z)

    key_last, key_rest = jax.random.split(key)
    L_last = jnp.linalg.cholesky(Js[-1])
    mean_last = jnp.linalg.solve(Js[-1], hs[-1])
    x_last = mean_last + jax.scipy.linalg.solve_triangular(
        L_last.T, jax.random.normal(key_last, (n,), dtype), lower=False)

    def step(x_next, inp):
        h, J, AtQinv_next, AtQinvA_next, k = inp
        Jc = J + AtQinvA_next
        mean = jnp.linalg.solve(Jc, h + AtQinv_next @ x_next)
        L = jnp.linalg.cholesky(Jc)
        x = mean + jax.scipy.linalg.solve_triangular(
            L.T, jax.random.normal(k, (n,), dtype), lower=False)
        return x, x

    keys = jax.random.split(key_rest, T - 1)
    # backward: conditioning of x_t on x_{t+1} uses transition t+1's matrices
    _, xs = jax.lax.scan(step, x_last,
                         (hs[:-1][::-1], Js[:-1][::-1],
                          AtQinv_t[1:][::-1], AtQinvA_t[1:][::-1], keys))
    return jnp.concatenate([xs[::-1], x_last[None]], axis=0)


# --------------------------------------------------------------------------
# z | x: discrete messages with AR-transition emissions
# (`slds/helper.py:645-1055`)
# --------------------------------------------------------------------------

def ar_logliks(params: SLDSParams, x) -> jax.Array:
    """logP [T, K] = log N(x_t; A_k x_{t-1}, Q_k); row 0 uses a flat
    pseudo-likelihood (the reference ignores the initial state's
    transition term, `slds/helper.py:1056-1079`)."""
    T = x.shape[0]
    x_prev = x[:-1]                                    # [T-1, n]
    x_cur = x[1:]
    mean = jnp.einsum('kij,tj->tki', params.A, x_prev)
    diff = x_cur[:, None, :] - mean                    # [T-1, K, n]
    LQ = params.LQinv
    zq = jnp.einsum('tki,kij->tkj', diff, LQ)
    half_logdet = jnp.sum(jnp.log(jnp.abs(
        jnp.diagonal(LQ, axis1=-2, axis2=-1))), axis=-1)
    ll = (-0.5 * params.n * _LOG_2PI + half_logdet[None, :]
          - 0.5 * jnp.sum(zq * zq, axis=-1))
    return jnp.concatenate([jnp.zeros((1, params.num_states), x.dtype), ll])


def z_marginal_loglikelihood(params: SLDSParams, observations, x):
    """log p(x | theta) (+ y-emission terms, z marginalized)
    (`slds/helper.py:779-815`)."""
    logP = ar_logliks(params, x)
    K = params.num_states
    fwd0 = hmm.default_forward_message(K, x.dtype)
    bwd0 = hmm.default_backward_message(K, x.dtype)
    ll = hmm.marginal_loglikelihood(logP, params.pi, fwd0, bwd0)
    # y | x emission terms (independent of z)
    diff = observations - x @ params.C.T
    zr = diff @ params.LRinv
    ll += jnp.sum(-0.5 * params.m * _LOG_2PI
                  + jnp.sum(jnp.log(jnp.abs(jnp.diag(params.LRinv))))
                  - 0.5 * jnp.sum(zr * zr, axis=-1))
    return ll


def z_latent_var_sample(params: SLDSParams, key, observations, x):
    """FFBS sample of z | x (`slds/helper.py:947-1055`)."""
    logP = ar_logliks(params, x)
    K = params.num_states
    return hmm.latent_var_sample(
        key, logP, params.pi, hmm.default_forward_message(K, x.dtype),
        hmm.default_backward_message(K, x.dtype))


# --------------------------------------------------------------------------
# Joint interface with reference semantics
# --------------------------------------------------------------------------

def marginal_loglikelihood(params: SLDSParams, observations, x=None, z=None):
    """Conditional marginals only (`slds/helper.py:1188-1222`)."""
    if z is not None:
        return x_marginal_loglikelihood(params, observations, z)
    if x is not None:
        return z_marginal_loglikelihood(params, observations, x)
    raise NotImplementedError(
        "SLDS marginal likelihood requires conditioning on x or z")


def complete_data_loglikelihood(params: SLDSParams, observations, x, z):
    """log p(y, x, z | theta) (`slds/helper.py:1080-1121`)."""
    T = observations.shape[0]
    K = params.num_states
    dtype = observations.dtype
    # z transitions
    zo = jax.nn.one_hot(z, K, dtype=dtype)
    counts = jnp.einsum('ti,tj->ij', zo[:-1], zo[1:])
    ll = jnp.sum(counts * jnp.log(params.pi + 1e-99))
    # x transitions
    logP = ar_logliks(params, x)
    ll += jnp.sum(jnp.take_along_axis(logP[1:], z[1:, None], axis=1))
    # emissions
    diff = observations - x @ params.C.T
    zr = diff @ params.LRinv
    ll += jnp.sum(-0.5 * params.m * _LOG_2PI
                  + jnp.sum(jnp.log(jnp.abs(jnp.diag(params.LRinv))))
                  - 0.5 * jnp.sum(zr * zr, axis=-1))
    return ll


def gradient_complete_data_loglikelihood(params: SLDSParams, observations,
                                         x, z) -> SLDSParams:
    """Autodiff complete-data score (`slds/helper.py:1122-1187`) — the
    complete-data likelihood is closed-form, so the vectorized gradient is
    jax.grad of it (numerically identical to the hand-derived formulas)."""
    return jax.grad(
        lambda p: complete_data_loglikelihood(p, observations, x, z))(params)


# --------------------------------------------------------------------------
# Prior + Gibbs (`slds/parameters.py`, conjugate updates)
# --------------------------------------------------------------------------

@pytree.dataclass
class SLDSPrior:
    alpha_pi: jax.Array       # (K, K)
    mean_A: jax.Array         # (K, n, n)
    var_col_A: jax.Array      # (K, n)
    scale_Qinv: jax.Array     # (K, n, n)
    df_Qinv: jax.Array
    mean_C: jax.Array         # (m, n)
    var_col_C: jax.Array      # (n,)
    scale_Rinv: jax.Array     # (m, m)
    df_Rinv: jax.Array


def default_prior(num_states: int, n: int = 1, m: int = 1,
                  var: float = 100.0, dtype=jnp.float64) -> SLDSPrior:
    """Host-NumPy leaves (no eager device dispatch)."""
    npdtype = np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    df_q = n + 1.0 + 1.0 / var
    df_r = m + 1.0 + 1.0 / var
    return SLDSPrior(
        alpha_pi=np.full((num_states, num_states), 1.0 / var, npdtype),
        mean_A=np.zeros((num_states, n, n), npdtype),
        var_col_A=np.full((num_states, n), var, npdtype),
        scale_Qinv=np.tile(np.eye(n, dtype=npdtype) / df_q,
                           (num_states, 1, 1)),
        df_Qinv=np.asarray(df_q, npdtype),
        mean_C=np.zeros((m, n), npdtype),
        var_col_C=np.full((n,), var, npdtype),
        scale_Rinv=np.eye(m, dtype=npdtype) / df_r,
        df_Rinv=np.asarray(df_r, npdtype),
    )


def logprior(prior: SLDSPrior, params: SLDSParams) -> jax.Array:
    """log p(theta): Dirichlet rows on pi, per-state matrix-normal-Wishart
    on (A_k, Qinv_k), matrix-normal-Wishart on (C, Rinv)
    (`slds/parameters.py` prior structure via `variables/*.py` helpers)."""
    K, n, _ = prior.mean_A.shape
    m = prior.mean_C.shape[0]
    pi = params.pi
    a = prior.alpha_pi
    lp = jnp.sum((a - 1.0) * jnp.log(pi + 1e-16))
    lp += jnp.sum(jax.scipy.special.gammaln(jnp.sum(a, -1))
                  - jnp.sum(jax.scipy.special.gammaln(a), -1))
    # Wishart on Qinv_k, Rinv
    lp += jnp.sum(jax.vmap(wishart_logpdf, in_axes=(0, None, 0))(
        params.Qinv, prior.df_Qinv, prior.scale_Qinv))
    lp += wishart_logpdf(params.Rinv, prior.df_Rinv, prior.scale_Rinv)
    # A_k | Q_k ~ MN(mean_A, Q_k, diag(var_col_A))
    LQ = params.LQinv
    half_logdet_q = jnp.sum(jnp.log(jnp.abs(
        jnp.diagonal(LQ, axis1=-2, axis2=-1))), axis=-1)        # [K]
    diffA = params.A - prior.mean_A
    quadA = jnp.einsum('kij,kil,klj,kj->', diffA, params.Qinv, diffA,
                       1.0 / prior.var_col_A)
    lp += (jnp.sum(n * half_logdet_q)
           - 0.5 * n * jnp.sum(jnp.log(prior.var_col_A))
           - 0.5 * n * n * K * _LOG_2PI - 0.5 * quadA)
    # C | R ~ MN(mean_C, R, diag(var_col_C))
    LR = params.LRinv
    half_logdet_r = jnp.sum(jnp.log(jnp.abs(jnp.diag(LR))))
    diffC = params.C - prior.mean_C
    quadC = jnp.einsum('ij,il,lj,j->', diffC, params.Rinv, diffC,
                       1.0 / prior.var_col_C)
    lp += (n * half_logdet_r - 0.5 * m * jnp.sum(jnp.log(prior.var_col_C))
           - 0.5 * m * n * _LOG_2PI - 0.5 * quadC)
    return lp


def grad_logprior(prior: SLDSPrior, params: SLDSParams) -> SLDSParams:
    """Autodiff score of the (closed-form, smooth) log-prior in the stored
    coordinates (logit_pi, A, LQinv_vec, C, LRinv_vec)."""
    return jax.grad(lambda p: logprior(prior, p))(params)


def windowed_complete_data_loglikelihood(params: SLDSParams, window, x, z,
                                         step_weights) -> jax.Array:
    """Per-step weighted complete-data loglikelihood over a buffered
    window (`SLDSSampler._subsequence_gradient` kind='complete',
    `slds/sampler.py:612-660`): step t carries its emission term and the
    (t-1 -> t) transition terms, weighted by ``step_weights`` (the
    subsequence unbiasedness weights inside the window, zero on buffers).
    Step 0 carries no transition term (the reference's empty
    forward_message at a sequence start)."""
    K = params.num_states
    dtype = window.dtype
    w = step_weights.astype(dtype)
    # z-transition terms into t (0 at t=0)
    log_pi = jnp.log(params.pi + 1e-99)
    trans_z = jnp.concatenate(
        [jnp.zeros((1,), dtype), log_pi[z[:-1], z[1:]]])
    # x-transition terms into t
    logP = ar_logliks(params, x)                    # [W, K]
    trans_x = jnp.concatenate(
        [jnp.zeros((1,), dtype),
         jnp.take_along_axis(logP[1:], z[1:, None], axis=1)[:, 0]])
    # emission terms
    diff = window - x @ params.C.T
    zr = diff @ params.LRinv
    emit = (-0.5 * params.m * _LOG_2PI
            + jnp.sum(jnp.log(jnp.abs(jnp.diag(params.LRinv))))
            - 0.5 * jnp.sum(zr * zr, axis=-1))
    return jnp.sum(w * (trans_z + trans_x + emit))


def windowed_complete_gradient(params: SLDSParams, window, x, z,
                               step_weights):
    """(grad_tree, weighted loglik) for one buffered window given latent
    draws (x, z) on the window."""
    ll, grad = jax.value_and_grad(
        lambda p: windowed_complete_data_loglikelihood(
            p, window, x, z, step_weights))(params)
    return grad, ll


def sample_prior(prior: SLDSPrior, key) -> SLDSParams:
    K, n, _ = prior.mean_A.shape
    m = prior.mean_C.shape[0]
    dtype = prior.mean_A.dtype
    kp, kq, ka, kr, kc = jax.random.split(key, 5)
    g = jax.random.gamma(kp, prior.alpha_pi, dtype=dtype)
    pi = g / jnp.sum(g, axis=-1, keepdims=True)
    Qinv = jax.vmap(sample_wishart, in_axes=(0, None, 0))(
        jax.random.split(kq, K), prior.df_Qinv, prior.scale_Qinv)
    LQinv = jnp.linalg.cholesky(Qinv)
    zA = jax.random.normal(ka, (K, n, n), dtype)
    A = prior.mean_A + jax.vmap(
        lambda L, z, vc: jax.scipy.linalg.solve_triangular(
            L.T, z, lower=False) * jnp.sqrt(vc)[None, :])(
        LQinv, zA, prior.var_col_A)
    Rinv = sample_wishart(kr, prior.df_Rinv, prior.scale_Rinv)
    LRinv = jnp.linalg.cholesky(Rinv)
    zC = jax.random.normal(kc, (m, n), dtype)
    C = prior.mean_C + jax.scipy.linalg.solve_triangular(
        LRinv.T, zC, lower=False) * jnp.sqrt(prior.var_col_C)[None, :]
    return SLDSParams(
        logit_pi=jnp.log(pi + 1e-99), A=A,
        LQinv_vec=jax.vmap(mat_to_tril_vector)(LQinv),
        C=C, LRinv_vec=mat_to_tril_vector(LRinv))


def _mniw_posterior(Spp, Scp, Scc, count, mean_M, var_col, scale_Vinv,
                    df_Vinv):
    """Matrix-normal-inverse-Wishart conjugate update.

    Returns (df_post, scale_post, M_mean, Spp_post): the Wishart posterior
    on Vinv is W(df_post, scale_post) and M | V ~ MN(M_mean, V,
    inv(Spp_post)) — identical math to the reference's marginal-V-then-M|V
    factorization (`variables/covariance.py:207-240` +
    `variables/matrices.py:780-808`)."""
    prec = jnp.diag(1.0 / var_col)
    Spp = prec + Spp
    Scp = mean_M / var_col[None, :] + Scp
    Scc = (mean_M / var_col[None, :]) @ mean_M.T + Scc
    S_schur = Scc - Scp @ jnp.linalg.solve(Spp, Scp.T)
    df_post = df_Vinv + count
    scale_post = jnp.linalg.inv(jnp.linalg.inv(scale_Vinv) + S_schur)
    M_mean = jnp.linalg.solve(Spp, Scp.T).T
    return df_post, scale_post, M_mean, Spp


def _mniw_sample(key, Spp, Scp, Scc, count, mean_M, var_col, scale_Vinv,
                 df_Vinv, dtype):
    df_post, scale_post, M_mean, Spp_post = _mniw_posterior(
        Spp, Scp, Scc, count, mean_M, var_col, scale_Vinv, df_Vinv)
    k_v, k_m = jax.random.split(key)
    Vinv = sample_wishart(k_v, df_post, scale_post)
    LVinv = jnp.linalg.cholesky(Vinv)
    L_col = jnp.linalg.cholesky(jnp.linalg.inv(Spp_post))
    Z = jax.random.normal(k_m, mean_M.shape, dtype)
    M = M_mean + jax.scipy.linalg.solve_triangular(
        LVinv.T, Z, lower=False) @ L_col.T
    return Vinv, M


def _gibbs_sufficient_stats(prior: SLDSPrior, observations, x, z):
    """(pi counts, per-state transition stats, emission stats) for the
    conjugate theta | x, z, y blocks (re-derivation of
    `slds/helper.py:1255-1331` calc_gibbs_sufficient_statistic; the
    reference's Q df uses sum(z==k) over ALL T including t=0 — an
    off-by-one that counts z_0's state, which has no incoming transition;
    ours counts sum(z[1:]==k), the actual number of transition
    observations for state k)."""
    K = prior.alpha_pi.shape[0]
    dtype = observations.dtype
    zo = jax.nn.one_hot(z, K, dtype=dtype)
    counts = jnp.einsum('ti,tj->ij', zo[:-1], zo[1:])
    w = zo[1:]                                         # [T-1, K]
    xp, xc = x[:-1], x[1:]
    Spp = jnp.einsum('tk,ti,tj->kij', w, xp, xp)
    Scp = jnp.einsum('tk,ti,tj->kij', w, xc, xp)
    Scc = jnp.einsum('tk,ti,tj->kij', w, xc, xc)
    n_k = jnp.sum(w, axis=0)
    Spp_y = x.T @ x
    Scp_y = observations.T @ x
    Scc_y = observations.T @ observations
    return counts, (Spp, Scp, Scc, n_k), (Spp_y, Scp_y, Scc_y)


def gibbs_posterior_params(prior: SLDSPrior, observations, x, z) -> dict:
    """Deterministic conjugate posterior hyperparameters for
    theta | x, z, y — the quantities the Gibbs draws are sampled from.

    Returns dict with 'alpha_pi' [K, K] Dirichlet rows, per-state
    'df_Q'/'scale_Q'/'mean_A'/'Spp_A' (Wishart on Qinv_k + matrix-normal
    col-precision on A_k), and 'df_R'/'scale_R'/'mean_C'/'Spp_C'.  Used by
    the SLDS adjudication harness to unit-compare one Gibbs update against
    the reference's calc_gibbs_sufficient_statistic + per-variable
    posteriors on a fixed (x, z, y)."""
    counts, (Spp, Scp, Scc, n_k), (Spp_y, Scp_y, Scc_y) = \
        _gibbs_sufficient_stats(prior, observations, x, z)
    df_q, scale_q, mean_a, spp_a = jax.vmap(
        lambda a, b, c, cnt, mA, vA, sQ: _mniw_posterior(
            a, b, c, cnt, mA, vA, sQ, prior.df_Qinv))(
        Spp, Scp, Scc, n_k, prior.mean_A, prior.var_col_A, prior.scale_Qinv)
    df_r, scale_r, mean_c, spp_c = _mniw_posterior(
        Spp_y, Scp_y, Scc_y, observations.shape[0], prior.mean_C,
        prior.var_col_C, prior.scale_Rinv, prior.df_Rinv)
    return dict(alpha_pi=prior.alpha_pi + counts,
                df_Q=df_q, scale_Q=scale_q, mean_A=mean_a, Spp_A=spp_a,
                df_R=df_r, scale_R=scale_r, mean_C=mean_c, Spp_C=spp_c)


def gibbs_parameters_sample(key, prior: SLDSPrior, observations, x, z
                            ) -> SLDSParams:
    """theta | x, z, y — conjugate blocks (`calc_gibbs_sufficient_statistic`
    + per-variable posteriors)."""
    K = prior.alpha_pi.shape[0]
    dtype = observations.dtype
    kp, kq, kr = jax.random.split(key, 3)

    counts, (Spp, Scp, Scc, n_k), (Spp_y, Scp_y, Scc_y) = \
        _gibbs_sufficient_stats(prior, observations, x, z)
    g = jax.random.gamma(kp, prior.alpha_pi + counts, dtype=dtype)
    pi = g / jnp.sum(g, axis=-1, keepdims=True)

    # per-state (A_k, Q_k) from transitions assigned to state z_t
    keys_q = jax.random.split(kq, K)
    Qinv, A = jax.vmap(
        lambda k, a, b, c, cnt, mA, vA, sQ: _mniw_sample(
            k, a, b, c, cnt, mA, vA, sQ, prior.df_Qinv, dtype))(
        keys_q, Spp, Scp, Scc, n_k, prior.mean_A, prior.var_col_A,
        prior.scale_Qinv)

    # shared (C, R) from all emissions
    Rinv, C = _mniw_sample(kr, Spp_y, Scp_y, Scc_y, observations.shape[0],
                           prior.mean_C, prior.var_col_C, prior.scale_Rinv,
                           prior.df_Rinv, dtype)
    return SLDSParams(
        logit_pi=jnp.log(pi + 1e-99), A=A,
        LQinv_vec=jax.vmap(mat_to_tril_vector)(jnp.linalg.cholesky(Qinv)),
        C=C, LRinv_vec=mat_to_tril_vector(jnp.linalg.cholesky(Rinv)))


def gibbs_step(key, prior: SLDSPrior, params: SLDSParams, observations,
               x, z):
    """One blocked sweep: x | z, theta -> z | x, theta -> theta | x, z
    (`slds/sampler.py` blocked Gibbs).  Returns (params, x, z)."""
    kx, kz, kp = jax.random.split(key, 3)
    x = x_latent_var_sample(params, kx, observations, z)
    z = z_latent_var_sample(params, kz, observations, x)
    params = gibbs_parameters_sample(kp, prior, observations, x, z)
    return params, x, z


def project_parameters(params: SLDSParams, a_threshold: float = 0.9999,
                       fix_C_eye: bool = True) -> SLDSParams:
    from ..utils.linalg import spectral_norm_projection
    logit_pi = params.logit_pi - jnp.mean(params.logit_pi, axis=1,
                                          keepdims=True)
    A = jax.vmap(lambda Ak: spectral_norm_projection(Ak, a_threshold))(
        params.A)
    LQ = params.LQinv
    idx = jnp.arange(LQ.shape[-1])
    LQ = LQ.at[:, idx, idx].set(jnp.abs(LQ[:, idx, idx]))
    LR = tril_vector_to_mat(params.LRinv_vec)
    idr = jnp.arange(LR.shape[-1])
    LR = LR.at[idr, idr].set(jnp.abs(jnp.diag(LR)))
    C = jnp.eye(params.m, params.n, dtype=params.C.dtype) if fix_C_eye \
        else params.C
    return SLDSParams(logit_pi=logit_pi, A=A,
                      LQinv_vec=jax.vmap(mat_to_tril_vector)(LQ),
                      C=C, LRinv_vec=mat_to_tril_vector(LR))


@functools.partial(jax.jit, static_argnames=("T",))
def generate_data(key, params: SLDSParams, T: int):
    """Simulate (y [T, m], x [T, n], z [T])."""
    params = jax.tree_util.tree_map(jnp.asarray, params)
    K, n = params.num_states, params.n
    m = params.m
    dtype = params.A.dtype
    kz, kx, ky, k0 = jax.random.split(key, 4)
    LQ_chol = jnp.linalg.cholesky(params.Q)
    LR_chol = jnp.linalg.cholesky(params.R)
    log_pi = jnp.log(params.pi + 1e-99)
    z_keys = jax.random.split(kz, T)
    eps_x = jax.random.normal(kx, (T, n), dtype)
    eps_y = jax.random.normal(ky, (T, m), dtype)
    z0 = jax.random.categorical(k0, jnp.zeros((K,), dtype))
    x0 = jnp.zeros((n,), dtype)

    def body(carry, inp):
        z_prev, x_prev = carry
        k, ex, ey = inp
        z = jax.random.categorical(k, log_pi[z_prev])
        x = params.A[z] @ x_prev + LQ_chol[z] @ ex
        y = params.C @ x + LR_chol @ ey
        return (z, x), (z, x, y)

    _, (zs, xs, ys) = jax.lax.scan(body, (z0, x0), (z_keys, eps_x, eps_y))
    return ys, xs, zs
