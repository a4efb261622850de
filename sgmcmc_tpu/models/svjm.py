"""Stochastic-volatility jump model (SVJM).

x_t = A x_{t-1} + N(0, Q) + J_t * N(0, QJ),   J_t ~ Bernoulli(pJ),
y_t ~ N(0, exp(x_t) * R)

The reference *intends* to ship this model — its
`particle_filters/custom_kernels.py:150-381` defines `SVJMEPKernel` /
`SVJMEPAvgKernel` jump-diffusion proposal kernels over exactly these
parameters (`pJ`, `phi`, `sigma2`, `sigmaJ2`, `Ltau2inv`) — but the module
cannot even be imported (the kernels subclass an undefined
`SVJMPriorKernel`) and no SVJM parameter/helper/sampler classes exist.
This module is the working model family those kernels imply, built in the
framework's functional style: the transition is the two-component Gaussian
mixture `(1-pJ) N(A x, Q) + pJ N(A x, Q + QJ)` (the mixture log-density the
reference evaluates at `custom_kernels.py:225-240`), the emission is the
SVM emission, and the Fisher-identity additive score is derived in the
unconstrained coordinates (A, LQinv, LRinv, logit_pJ, LQJinv).

Deliberate delta (documented): the reference's `SVJMEPAvgKernel.rv` draws
the *larger-variance* mixture component with probability `1 - x_pJ` while
its `reweight` divides by the density that assigns that component
probability `x_pJ` (`custom_kernels.py:316-330` vs `:369-378`) — a
sampler/density mismatch that biases the estimator.  Here `ep_avg` samples
the same mixture its reweight divides by.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from ..utils import pytree

from ..utils.distributions import (beta_logpdf, matrix_normal_logpdf,
                                   sample_beta, sample_wishart,
                                   wishart_logpdf)
from ..utils.linalg import tril_vector_to_mat
from .base import ParticleKernel

_LOG_2PI = 1.8378770664093453


@pytree.dataclass
class SVJMParams:
    """SVJM parameter pytree (unconstrained reference-style coordinates)."""
    A: jax.Array            # (1, 1) AR coefficient (phi)
    LQinv_vec: jax.Array    # (1,) chol(Q^-1)      -> sigma
    LRinv_vec: jax.Array    # (1,) chol(R^-1)      -> tau (Ltau2inv)
    logit_pJ: jax.Array     # (1,) jump probability, logit space
    LQJinv_vec: jax.Array   # (1,) chol(QJ^-1)     -> sigmaJ

    @property
    def a(self):
        return self.A[0, 0]

    @property
    def lqinv(self):
        return self.LQinv_vec[0]

    @property
    def lrinv(self):
        return self.LRinv_vec[0]

    @property
    def lqjinv(self):
        return self.LQJinv_vec[0]

    @property
    def Q(self):
        return 1.0 / (self.lqinv * self.lqinv)

    @property
    def R(self):
        return 1.0 / (self.lrinv * self.lrinv)

    @property
    def QJ(self):
        return 1.0 / (self.lqjinv * self.lqjinv)

    @property
    def pJ(self):
        return jax.nn.sigmoid(self.logit_pJ[0])

    # Reference aliases (`custom_kernels.py` uses phi/sigma2/sigmaJ2/Ltau2inv)
    @property
    def phi(self):
        return self.a

    @property
    def sigma(self):
        return 1.0 / jnp.abs(self.lqinv)

    @property
    def sigmaJ(self):
        return 1.0 / jnp.abs(self.lqjinv)

    @property
    def tau(self):
        return 1.0 / jnp.abs(self.lrinv)


def from_scalars(A: float, Q: float, R: float, pJ: float = 0.05,
                 QJ: float = 1.0, dtype=jnp.float32) -> SVJMParams:
    """Build params from natural (A, Q, R, pJ, QJ) scalars (host leaves)."""
    import numpy as onp
    npdtype = onp.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    pJ = min(max(float(pJ), 1e-6), 1.0 - 1e-6)
    return SVJMParams(
        A=onp.full((1, 1), A, npdtype),
        LQinv_vec=onp.full((1,), Q ** -0.5, npdtype),
        LRinv_vec=onp.full((1,), R ** -0.5, npdtype),
        logit_pJ=onp.full((1,), onp.log(pJ / (1.0 - pJ)), npdtype),
        LQJinv_vec=onp.full((1,), QJ ** -0.5, npdtype),
    )


def stationary_variance(params: SVJMParams) -> jax.Array:
    """Stationary variance (Q + pJ*QJ) / (1 - A^2), capped like the SVM."""
    v = (params.Q + params.pJ * params.QJ) / (1.0 - params.a ** 2)
    return jnp.minimum(v, 1e3)


# --------------------------------------------------------------------------
# Transition mixture density (the density `SVJMEPKernel.reweight` evaluates,
# `custom_kernels.py:225-240`)
# --------------------------------------------------------------------------

def _mixture_logpdf(params: SVJMParams, diff):
    """log[(1-pJ) N(d; 0, Q) + pJ N(d; 0, Q+QJ)] elementwise over d."""
    v0 = params.Q
    v1 = params.Q + params.QJ
    lp0 = -0.5 * diff * diff / v0 - 0.5 * (_LOG_2PI + jnp.log(v0))
    lp1 = -0.5 * diff * diff / v1 - 0.5 * (_LOG_2PI + jnp.log(v1))
    lpj = jax.nn.log_sigmoid(params.logit_pJ[0])       # log pJ
    lpn = jax.nn.log_sigmoid(-params.logit_pJ[0])      # log (1-pJ)
    return jnp.logaddexp(lpn + lp0, lpj + lp1)


def _jump_responsibility(params: SVJMParams, diff):
    """Posterior P(J=1 | x, x') = sigmoid(logit_pJ + logN1 - logN0)."""
    v0 = params.Q
    v1 = params.Q + params.QJ
    lp0 = -0.5 * diff * diff / v0 - 0.5 * jnp.log(v0)
    lp1 = -0.5 * diff * diff / v1 - 0.5 * jnp.log(v1)
    return jax.nn.sigmoid(params.logit_pJ[0] + lp1 - lp0)


# --------------------------------------------------------------------------
# Particle kernels
# --------------------------------------------------------------------------

def _sample_x0(params: SVJMParams, key, n_particles, prior_mean, prior_var):
    z = jax.random.normal(key, (n_particles, 1), dtype=params.A.dtype)
    return prior_mean + jnp.sqrt(prior_var) * z


def _propose(params: SVJMParams, key, x_t, y_next):
    """Bootstrap: J ~ Bern(pJ), x' = A x + sqrt(Q + J*QJ) z."""
    kj, kz = jax.random.split(key)
    z = jax.random.normal(kz, x_t.shape, dtype=x_t.dtype)
    jump = jax.random.bernoulli(kj, params.pJ, x_t.shape).astype(x_t.dtype)
    sd = jnp.sqrt(params.Q + jump * params.QJ)
    return params.a * x_t + sd * z


def _reweight(params: SVJMParams, x_t, x_next, y_next):
    """Emission log N(y; 0, exp(x) R) — identical to the SVM
    (`custom_kernels.py:218-223`), with the same float32 exp clip."""
    x = x_next[:, 0]
    return (-0.5 * _LOG_2PI
            - 0.5 * (y_next[0] ** 2) * jnp.exp(jnp.clip(-x, -60.0, 60.0))
            * (params.lrinv * params.lrinv)
            + jnp.log(jnp.abs(params.lrinv))
            - 0.5 * x)


def _prior_log_density(params: SVJMParams, x_t, x_next):
    return _mixture_logpdf(params, x_next[..., 0] - params.a * x_t[..., 0])


def _prior_log_density_max(params: SVJMParams):
    """Both mixture branches peak at d = 0."""
    return _mixture_logpdf(params, jnp.zeros(()))


KERNEL = ParticleKernel(
    sample_x0=_sample_x0,
    propose=_propose,
    reweight=_reweight,
    prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max,
    state_dim=1,
)


# Per-particle EP proposal (`SVJMEPKernel`, `custom_kernels.py:150-258`):
# Gauss-Hermite moment matching of each transition branch tilted by the
# emission, mixture proposal with the quadrature-posterior jump probability.

_GH_POINTS = 32


def _ep_branch_moments(mean, var, scaled_y2, dtype):
    """GH moments of N(x'; mean, var) * exp(-0.5 scaled_y2 e^{-x'} - x'/2).

    Returns (log Z, posterior mean, posterior var); mean/scaled_y2 [N]."""
    import numpy as onp
    nodes, weights = onp.polynomial.hermite_e.hermegauss(_GH_POINTS)
    nodes = jnp.asarray(nodes, dtype)
    log_gh_w = jnp.log(jnp.asarray(weights, dtype))
    xs = mean[:, None] + jnp.sqrt(var) * nodes[None, :]          # [N, G]
    log_tilt = (-0.5 * scaled_y2[:, None]
                * jnp.exp(jnp.clip(-xs, -60.0, 60.0))
                - 0.5 * xs - 0.5 * _LOG_2PI)
    lw = log_gh_w[None, :] + log_tilt                            # [N, G]
    m = jnp.max(lw, axis=1, keepdims=True)
    w = jnp.exp(lw - m)
    z = jnp.sum(w, axis=1)
    logz = jnp.log(z) + m[:, 0] - 0.5 * jnp.log(2 * jnp.pi)
    m1 = jnp.sum(w * xs, axis=1) / z
    m2 = jnp.sum(w * xs * xs, axis=1) / z
    return logz, m1, jnp.maximum(m2 - m1 * m1, 1e-8)


def _ep_fit(params: SVJMParams, x_t, y_next):
    """Per-particle `_calc_ep_fit` (`custom_kernels.py:151-184`)."""
    mean = params.a * x_t[:, 0]
    scaled_y2 = jnp.full_like(mean, (y_next[0] * params.lrinv) ** 2)
    dtype = x_t.dtype
    logz1, m1j, v1j = _ep_branch_moments(mean, params.Q + params.QJ,
                                         scaled_y2, dtype)
    logz0, m10, v10 = _ep_branch_moments(mean, params.Q, scaled_y2, dtype)
    x_pJ = jax.nn.sigmoid(params.logit_pJ[0] + logz1 - logz0)
    return dict(xJ_bar=m1j, xJ_var=v1j, x_bar=m10, x_var=v10, x_pJ=x_pJ)


def _ep_mixture_logq(fit, x1):
    lq0 = (-0.5 * _LOG_2PI - 0.5 * jnp.log(fit["x_var"])
           - 0.5 * (x1 - fit["x_bar"]) ** 2 / fit["x_var"])
    lq1 = (-0.5 * _LOG_2PI - 0.5 * jnp.log(fit["xJ_var"])
           - 0.5 * (x1 - fit["xJ_bar"]) ** 2 / fit["xJ_var"])
    return jnp.logaddexp(jnp.log1p(-fit["x_pJ"]) + lq0,
                         jnp.log(fit["x_pJ"]) + lq1)


def _propose_ep(params: SVJMParams, key, x_t, y_next):
    fit = _ep_fit(params, x_t, y_next)
    kj, kz = jax.random.split(key)
    jump = jax.random.bernoulli(kj, fit["x_pJ"]).astype(x_t.dtype)
    mean = jump * fit["xJ_bar"] + (1.0 - jump) * fit["x_bar"]
    sd = jnp.sqrt(jump * fit["xJ_var"] + (1.0 - jump) * fit["x_var"])
    z = jax.random.normal(kz, mean.shape, x_t.dtype)
    return (mean + sd * z)[:, None]


def _reweight_ep(params: SVJMParams, x_t, x_next, y_next):
    fit = _ep_fit(params, x_t, y_next)
    return (_prior_log_density(params, x_t, x_next)
            + _reweight(params, x_t, x_next, y_next)
            - _ep_mixture_logq(fit, x_next[:, 0]))


EP_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_ep, reweight=_reweight_ep,
    prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=1)


# Ensemble-averaged EP proposal (`SVJMEPAvgKernel`, `custom_kernels.py:260-381`):
# one shared two-component proposal fitted to the particle-ensemble
# predictive N(mean(x)*A, var(x)*A^2 + Q[+QJ]) tilted by the emission.

def _ep_avg_fit(params: SVJMParams, x_t, y_next):
    mean = jnp.mean(x_t[:, 0]) * params.a
    base_var = jnp.var(x_t[:, 0]) * params.a ** 2 + params.Q
    scaled_y2 = jnp.full((1,), (y_next[0] * params.lrinv) ** 2, x_t.dtype)
    logz1, m1j, v1j = _ep_branch_moments(mean[None], base_var + params.QJ,
                                         scaled_y2, x_t.dtype)
    logz0, m10, v10 = _ep_branch_moments(mean[None], base_var,
                                         scaled_y2, x_t.dtype)
    x_pJ = jax.nn.sigmoid(params.logit_pJ[0] + logz1[0] - logz0[0])
    return dict(xJ_bar=m1j[0], xJ_var=v1j[0], x_bar=m10[0], x_var=v10[0],
                x_pJ=x_pJ)


def _propose_ep_avg(params: SVJMParams, key, x_t, y_next):
    fit = _ep_avg_fit(params, x_t, y_next)
    kj, kz = jax.random.split(key)
    n = x_t.shape[0]
    jump = jax.random.bernoulli(kj, fit["x_pJ"], (n,)).astype(x_t.dtype)
    mean = jump * fit["xJ_bar"] + (1.0 - jump) * fit["x_bar"]
    sd = jnp.sqrt(jump * fit["xJ_var"] + (1.0 - jump) * fit["x_var"])
    z = jax.random.normal(kz, (n,), x_t.dtype)
    return (mean + sd * z)[:, None]


def _reweight_ep_avg(params: SVJMParams, x_t, x_next, y_next):
    fit = _ep_avg_fit(params, x_t, y_next)
    return (_prior_log_density(params, x_t, x_next)
            + _reweight(params, x_t, x_next, y_next)
            - _ep_mixture_logq(fit, x_next[:, 0]))


EP_AVG_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_ep_avg,
    reweight=_reweight_ep_avg, prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=1)


def get_kernel(name: str | None = None) -> ParticleKernel:
    if name in (None, "prior"):
        return KERNEL
    if name == "ep":
        return EP_KERNEL
    if name == "ep_avg":
        return EP_AVG_KERNEL
    raise ValueError(f"Unrecognized SVJM kernel '{name}'")


# --------------------------------------------------------------------------
# Additive statistics (Fisher-identity score)
# --------------------------------------------------------------------------

STATISTIC_DIM = 5  # [grad_LRinv, grad_LQinv, grad_A, grad_logit_pJ, grad_LQJinv]


def grad_statistic(params: SVJMParams, x_t, x_next, y_next, t):
    """Per-particle gradient of log Pr(y', x' | x, theta), [N, 5].

    The transition score is the responsibility-weighted mixture of branch
    scores: with r1 = P(J=1 | x, x') and v_k the branch variances,
    d/dθ log p(x'|x) = Σ_k r_k d/dθ log N(x'; A x, v_k).
    """
    x0 = x_t[:, 0]
    x1 = x_next[:, 0]
    d = x1 - params.a * x0
    v0 = params.Q
    v1 = params.Q + params.QJ
    r1 = _jump_responsibility(params, d)
    r0 = 1.0 - r1

    grad_A = d * x0 * (r0 / v0 + r1 / v1)
    # dv0/dlqinv = dv1/dlqinv = -2 Q / lqinv ;  dv1/dlqjinv = -2 QJ / lqjinv
    dlogN0_dv = 0.5 * d * d / (v0 * v0) - 0.5 / v0
    dlogN1_dv = 0.5 * d * d / (v1 * v1) - 0.5 / v1
    grad_LQinv = (-2.0 * params.Q / params.lqinv) * (r0 * dlogN0_dv
                                                     + r1 * dlogN1_dv)
    grad_LQJinv = (-2.0 * params.QJ / params.lqjinv) * r1 * dlogN1_dv
    grad_logit_pJ = r1 - params.pJ

    diff_y2 = (y_next[0] ** 2) * jnp.exp(jnp.clip(-x1, -60.0, 60.0))
    grad_LRinv = 1.0 / params.lrinv - diff_y2 * params.lrinv
    return jnp.stack([grad_LRinv, grad_LQinv, grad_A, grad_logit_pJ,
                      grad_LQJinv], axis=-1)


def suff_statistic(params: SVJMParams, x_t, x_next, y_next, t):
    """(x', x'^2, x x') Gaussian sufficient stats (diagnostics)."""
    x0 = x_t[:, 0]
    x1 = x_next[:, 0]
    return jnp.stack([x1, x1 * x1, x0 * x1], axis=-1)


def latent_moments(params: SVJMParams, stats):
    """[T, 3] averaged suff stats -> latent (mean [T,1], cov [T,1,1])."""
    x_mean = stats[:, 0]
    x_cov = stats[:, 1] - x_mean ** 2
    return x_mean[:, None], x_cov[:, None, None]


Y_STATISTIC_DIM = 1


def y_statistic(params: SVJMParams, x_t, x_next, y_next, t):
    """E[exp(x)] feature; emission y ~ N(0, exp(x) R) as in the SVM."""
    return jnp.exp(jnp.clip(x_next[:, 0], -60.0, 60.0))[:, None]


def y_moments(params: SVJMParams, stats):
    T = stats.shape[0]
    return (jnp.zeros((T, 1), stats.dtype),
            (params.R * stats[:, 0])[:, None, None])


def make_predictive_stat_fn(observations, num_steps_ahead: int,
                            n_mc: int = 1, base_key=None,
                            valid_length=None):
    """k-step-ahead predictive loglikelihood statistic (the SVM's
    `svm_predictive_loglikelihood` protocol, `svm/helper.py:352-395`,
    with the jump-diffusion moment recursion: Var[x_{t+1}] =
    A^2 Var[x_t] + Q + pJ*QJ).

    ``valid_length`` (traced scalar) masks horizons past the true sequence
    end for padded multi-sequence batching."""
    T = observations.shape[0]
    T_valid = T if valid_length is None else valid_length
    if base_key is None:
        base_key = jax.random.PRNGKey(0)

    def stat_fn(params, x_t, x_next, y_next, t):
        N = x_next.shape[0]
        a, R = params.a, params.R
        q_step = params.Q + params.pJ * params.QJ
        out = []
        x_mean = x_next[:, 0]
        x_var = jnp.zeros(())
        for k in range(num_steps_ahead + 1):
            tk = jnp.clip(t + k, 0, T - 1)
            in_range = (t + k < T_valid).astype(x_mean.dtype)
            y_tk = observations[tk, 0]
            z = jax.random.normal(jax.random.fold_in(base_key, 7919 * k + 1),
                                  (N, n_mc), x_mean.dtype)
            x_mc = x_mean[:, None] + jnp.sqrt(x_var) * z
            y_var = R * jnp.exp(x_mc)
            ll = jnp.mean(-0.5 * y_tk ** 2 / y_var
                          - 0.5 * _LOG_2PI - 0.5 * jnp.log(y_var), axis=1)
            out.append(in_range * ll)
            x_mean = a * x_mean
            x_var = q_step + a * a * x_var
        return jnp.stack(out, axis=-1)

    return stat_fn


def unpack_grad(stat: jax.Array) -> SVJMParams:
    return SVJMParams(
        A=stat[2].reshape(1, 1),
        LQinv_vec=stat[1].reshape(1),
        LRinv_vec=stat[0].reshape(1),
        logit_pJ=stat[3].reshape(1),
        LQJinv_vec=stat[4].reshape(1),
    )


# --------------------------------------------------------------------------
# Fused-kernel bundle (bootstrap proposal).  One carried state dim (x);
# n_noise = 2: the second per-step normal is thresholded at Phi^{-1}(pJ)
# (packed outside the kernel) to draw the jump indicator — equal in
# distribution to Bernoulli(pJ).
# --------------------------------------------------------------------------

def _fused_pack(params: SVJMParams) -> jax.Array:
    from jax.scipy.special import ndtri
    pj = jnp.clip(params.pJ, 1e-6, 1.0 - 1e-6)
    return jnp.stack([params.a, params.lqinv, params.lrinv, params.lqjinv,
                      params.logit_pJ[0], ndtri(pj)])


def _fused_init(z, prior_mean, prior_var):
    return [prior_mean + jnp.sqrt(prior_var) * z[0]]


def _fused_propose(pv, z, x, y_t):
    a, lqinv, _, lqjinv, _, ndtri_pj = pv
    jump = (z[1] < ndtri_pj).astype(z[0].dtype)
    var = 1.0 / (lqinv * lqinv) + jump / (lqjinv * lqjinv)
    return [a * x[0] + jnp.sqrt(var) * z[0]]


def _fused_reweight(pv, x, x_new, y_t):
    _, _, lrinv, _, _, _ = pv
    xn = x_new[0]
    return (-0.5 * _LOG_2PI
            - 0.5 * (y_t ** 2) * jnp.exp(jnp.clip(-xn, -60.0, 60.0))
            * (lrinv * lrinv)
            + jnp.log(jnp.abs(lrinv))
            - 0.5 * xn)


def _fused_stat(pv, x, x_new, y_t):
    a, lqinv, lrinv, lqjinv, logit_pj, _ = pv
    x0, x1 = x[0], x_new[0]
    d = x1 - a * x0
    v0 = 1.0 / (lqinv * lqinv)
    vj = 1.0 / (lqjinv * lqjinv)
    v1 = v0 + vj
    # r1 = sigmoid(logit_pJ + logN1 - logN0)
    dlog = (-0.5 * d * d / v1 - 0.5 * jnp.log(v1)
            + 0.5 * d * d / v0 + 0.5 * jnp.log(v0))
    r1 = 1.0 / (1.0 + jnp.exp(jnp.clip(-(logit_pj + dlog), -60.0, 60.0)))
    r0 = 1.0 - r1
    pj = 1.0 / (1.0 + jnp.exp(jnp.clip(-logit_pj, -60.0, 60.0)))

    grad_A = d * x0 * (r0 / v0 + r1 / v1)
    dlogN0_dv = 0.5 * d * d / (v0 * v0) - 0.5 / v0
    dlogN1_dv = 0.5 * d * d / (v1 * v1) - 0.5 / v1
    grad_LQinv = (-2.0 * v0 / lqinv) * (r0 * dlogN0_dv + r1 * dlogN1_dv)
    grad_LQJinv = (-2.0 * vj / lqjinv) * r1 * dlogN1_dv
    grad_logit_pJ = r1 - pj
    diff_y2 = (y_t ** 2) * jnp.exp(jnp.clip(-x1, -60.0, 60.0))
    grad_LRinv = 1.0 / lrinv - diff_y2 * lrinv
    return [grad_LRinv, grad_LQinv, grad_A, grad_logit_pJ, grad_LQJinv]


def _make_fused():
    from ..ops.pallas.fused_pf import FusedModel
    return FusedModel(n_state=1, n_stat=STATISTIC_DIM, n_param=6,
                      pack_params=_fused_pack, propose=_fused_propose,
                      reweight=_fused_reweight, stat=_fused_stat,
                      init=_fused_init, n_noise=2)


FUSED = _make_fused()


def get_fused(name: str | None = None):
    return FUSED if name in (None, "prior") else None


# --------------------------------------------------------------------------
# Prior: Wishart(Qinv), Wishart(Rinv), Wishart(QJinv), MN(A | Q),
# Beta(pJ) with the GARCH-style unconstrained-space gradient convention.
# --------------------------------------------------------------------------

@pytree.dataclass
class SVJMPrior:
    mean_A: jax.Array        # (1, 1)
    var_col_A: jax.Array     # (1,)
    scale_Qinv: jax.Array    # (1, 1)
    df_Qinv: jax.Array       # ()
    scale_Rinv: jax.Array    # (1, 1)
    df_Rinv: jax.Array       # ()
    scale_QJinv: jax.Array   # (1, 1)
    df_QJinv: jax.Array      # ()
    alpha_pJ: jax.Array      # ()
    beta_pJ: jax.Array       # ()


def default_prior(var: float = 100.0, dtype=jnp.float32) -> SVJMPrior:
    """SVM defaults for (A, Q, R); Beta(2, 18) on pJ (mean 0.1 — jumps are
    rare); the QJ prior matches the Q prior.  Host-NumPy leaves."""
    import numpy as onp
    npdtype = onp.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    df = 2.0 + 1.0 / var
    return SVJMPrior(
        mean_A=onp.zeros((1, 1), npdtype),
        var_col_A=onp.full((1,), var, npdtype),
        scale_Qinv=onp.full((1, 1), 1.0 / df, npdtype),
        df_Qinv=onp.asarray(df, npdtype),
        scale_Rinv=onp.full((1, 1), 1.0 / df, npdtype),
        df_Rinv=onp.asarray(df, npdtype),
        scale_QJinv=onp.full((1, 1), 1.0 / df, npdtype),
        df_QJinv=onp.asarray(df, npdtype),
        alpha_pJ=onp.asarray(2.0, npdtype),
        beta_pJ=onp.asarray(18.0, npdtype),
    )


def logprior(prior: SVJMPrior, params: SVJMParams) -> jax.Array:
    LQinv = tril_vector_to_mat(params.LQinv_vec)
    lp = wishart_logpdf(LQinv @ LQinv.T, prior.df_Qinv, prior.scale_Qinv)
    LRinv = tril_vector_to_mat(params.LRinv_vec)
    lp += wishart_logpdf(LRinv @ LRinv.T, prior.df_Rinv, prior.scale_Rinv)
    LQJinv = tril_vector_to_mat(params.LQJinv_vec)
    lp += wishart_logpdf(LQJinv @ LQJinv.T, prior.df_QJinv,
                         prior.scale_QJinv)
    lp += matrix_normal_logpdf(
        params.A, prior.mean_A, Lrowprec=LQinv,
        Lcolprec=jnp.diag(prior.var_col_A ** -0.5))
    lp += beta_logpdf(params.pJ, prior.alpha_pJ, prior.beta_pJ)
    return lp


def grad_logprior(prior: SVJMPrior, params: SVJMParams) -> SVJMParams:
    """Analytic prior score; (A, LQinv, LRinv) terms are the SVM's
    (`svm.grad_logprior`), the Beta term follows the reference's GARCH
    convention (chain-ruled density gradient, `garch_var.py:152-165`)."""
    lqinv, lrinv, lqjinv = params.lqinv, params.lrinv, params.lqjinv
    g_lqinv = (prior.df_Qinv - 2.0) / lqinv - lqinv / prior.scale_Qinv[0, 0]
    g_lrinv = (prior.df_Rinv - 2.0) / lrinv - lrinv / prior.scale_Rinv[0, 0]
    g_lqjinv = ((prior.df_QJinv - 2.0) / lqjinv
                - lqjinv / prior.scale_QJinv[0, 0])
    g_A = -(lqinv * lqinv) * (params.A - prior.mean_A) / prior.var_col_A
    pj = params.pJ
    g_logit_pJ = (prior.alpha_pJ - 1.0) * (1.0 - pj) - (prior.beta_pJ
                                                        - 1.0) * pj
    return SVJMParams(A=g_A,
                      LQinv_vec=g_lqinv.reshape(1),
                      LRinv_vec=g_lrinv.reshape(1),
                      logit_pJ=g_logit_pJ.reshape(1),
                      LQJinv_vec=g_lqjinv.reshape(1))


def sample_prior(prior: SVJMPrior, key) -> SVJMParams:
    kq, kr, kj, kp, ka = jax.random.split(key, 5)
    Qinv = sample_wishart(kq, prior.df_Qinv, prior.scale_Qinv)
    Rinv = sample_wishart(kr, prior.df_Rinv, prior.scale_Rinv)
    QJinv = sample_wishart(kj, prior.df_QJinv, prior.scale_QJinv)
    lqinv = jnp.sqrt(Qinv[0, 0])
    pj = sample_beta(kp, prior.alpha_pJ, prior.beta_pJ, lqinv.dtype)
    a_sd = jnp.sqrt(prior.var_col_A[0]) / lqinv
    A = prior.mean_A + a_sd * jax.random.normal(ka, (1, 1), lqinv.dtype)
    return SVJMParams(
        A=A, LQinv_vec=lqinv.reshape(1),
        LRinv_vec=jnp.sqrt(Rinv[0, 0]).reshape(1),
        logit_pJ=jax.scipy.special.logit(
            jnp.clip(pj, 1e-6, 1.0 - 1e-6)).reshape(1),
        LQJinv_vec=jnp.sqrt(QJinv[0, 0]).reshape(1))


def project_parameters(params: SVJMParams,
                       a_threshold: float = 0.9999) -> SVJMParams:
    """|A| <= threshold, reflect Cholesky diagonals, keep pJ in (~0, ~1)."""
    return SVJMParams(
        A=jnp.clip(params.A, -a_threshold, a_threshold),
        LQinv_vec=jnp.abs(params.LQinv_vec),
        LRinv_vec=jnp.abs(params.LRinv_vec),
        logit_pJ=jnp.clip(params.logit_pJ, -13.0, 13.0),
        LQJinv_vec=jnp.abs(params.LQJinv_vec),
    )


# --------------------------------------------------------------------------
# Data generation
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("T",))
def generate_data(key, params: SVJMParams, T: int):
    """Simulate (observations [T, 1], latent [T, 1]) from the SVJM."""
    k0, kx, kj, ky = jax.random.split(key, 4)
    x0 = jnp.sqrt(stationary_variance(params)) * jax.random.normal(
        k0, (), dtype=params.A.dtype)
    zx = jax.random.normal(kx, (T,), dtype=params.A.dtype)
    zy = jax.random.normal(ky, (T,), dtype=params.A.dtype)
    jumps = jax.random.bernoulli(kj, params.pJ, (T,)).astype(params.A.dtype)

    def body(x_prev, inp):
        zx_t, zy_t, j_t = inp
        sd = jnp.sqrt(params.Q + j_t * params.QJ)
        x = params.a * x_prev + sd * zx_t
        y = jnp.exp(0.5 * x) * jnp.sqrt(params.R) * zy_t
        return x, (x, y)

    _, (xs, ys) = jax.lax.scan(body, x0, (zx, zy, jumps))
    return ys[:, None], xs[:, None]
