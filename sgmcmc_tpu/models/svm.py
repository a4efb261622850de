"""Stochastic-volatility model (SVM).

x_t = A x_{t-1} + N(0, Q),   y_t ~ N(0, exp(x_t) * R)

Functional rewrite of `/root/reference/sgmcmc_ssm/models/svm/` — parameters
are a frozen pytree in the reference's coordinates (A, packed Cholesky of the
precisions LQinv_vec / LRinv_vec, `svm/parameters.py:19-61`), the bootstrap
prior kernel is a pure propose/reweight pair (`svm/kernels.py:5-64`), and the
Fisher-identity additive score is `svm_complete_data_loglike_gradient`
(`svm/helper.py:297-350`).  The model is scalar (n = m = 1) like every
reference experiment; latent particles have shape [N, 1].
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from ..utils import pytree

from ..utils.distributions import (matrix_normal_logpdf, sample_wishart,
                                   wishart_logpdf)
from ..utils.linalg import tril_vector_to_mat
from .base import ParticleKernel

_LOG_2PI = 1.8378770664093453


@pytree.dataclass
class SVMParams:
    """SVM parameter pytree (reference coordinates)."""
    A: jax.Array            # (1, 1) AR coefficient
    LQinv_vec: jax.Array    # (1,) chol(Q^-1)
    LRinv_vec: jax.Array    # (1,) chol(R^-1)

    # Derived quantities (scalar views) ------------------------------------
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
    def qinv(self):
        return self.lqinv ** 2

    @property
    def rinv(self):
        return self.lrinv ** 2

    @property
    def Q(self):
        return 1.0 / self.qinv

    @property
    def R(self):
        return 1.0 / self.rinv

    # Reference aliases phi / sigma / tau (`svm/parameters.py:42-61`)
    @property
    def phi(self):
        return self.a

    @property
    def sigma(self):
        return 1.0 / jnp.abs(self.lqinv)

    @property
    def tau(self):
        return 1.0 / jnp.abs(self.lrinv)


def from_scalars(A: float, Q: float, R: float, dtype=jnp.float32) -> SVMParams:
    """Build params from natural (A, Q, R) scalars.

    Leaves are host NumPy arrays: constructors dispatch no device ops (one
    eager dispatch per leaf would each sync with the device); the first
    jitted use transfers them.
    """
    import numpy as onp
    npdtype = onp.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    return SVMParams(
        A=onp.full((1, 1), A, npdtype),
        LQinv_vec=onp.full((1,), Q ** -0.5, npdtype),
        LRinv_vec=onp.full((1,), R ** -0.5, npdtype),
    )


def stationary_variance(params: SVMParams) -> jax.Array:
    """Stationary variance Q / (1 - A^2) of the latent AR(1), capped so the
    PF initialization stays inside float32's exp range when the projection
    pins |A| at its boundary."""
    return jnp.minimum(params.Q / (1.0 - params.a ** 2), 1e3)


# --------------------------------------------------------------------------
# Particle kernel (bootstrap / prior), `svm/kernels.py:5-64`
# --------------------------------------------------------------------------

def _sample_x0(params: SVMParams, key, n_particles, prior_mean, prior_var):
    z = jax.random.normal(key, (n_particles, 1), dtype=params.A.dtype)
    return prior_mean + jnp.sqrt(prior_var) * z


def _propose(params: SVMParams, key, x_t, y_next):
    z = jax.random.normal(key, x_t.shape, dtype=x_t.dtype)
    return params.a * x_t + z / params.lqinv


def _reweight(params: SVMParams, x_t, x_next, y_next):
    """log Pr(y_{t+1} | x_{t+1}) for emission N(0, exp(x) R).

    The exponent is clipped to float32's safe range: without it, a single
    excursion of the latent below ~-90 makes every log-weight -inf and the
    filter (and then the whole SGLD chain) NaNs — the f64 reference never
    hits this."""
    x = x_next[:, 0]
    return (-0.5 * _LOG_2PI
            - 0.5 * (y_next[0] ** 2) * jnp.exp(jnp.clip(-x, -60.0, 60.0))
            * params.rinv
            + jnp.log(jnp.abs(params.lrinv))
            - 0.5 * x)


def _prior_log_density(params: SVMParams, x_t, x_next):
    diff = (x_next[..., 0] - params.a * x_t[..., 0])
    return (-0.5 * diff * diff * params.qinv
            - 0.5 * _LOG_2PI + jnp.log(jnp.abs(params.lqinv)))


def _prior_log_density_max(params: SVMParams):
    return -0.5 * _LOG_2PI + jnp.log(jnp.abs(params.lqinv))


KERNEL = ParticleKernel(
    sample_x0=_sample_x0,
    propose=_propose,
    reweight=_reweight,
    prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max,
    state_dim=1,
)


# --------------------------------------------------------------------------
# Adaptive proposal kernels (working rewrites of the reference's
# `particle_filters/custom_kernels.py:9-148`, whose module cannot even be
# imported — it subclasses an undefined `SVJMPriorKernel`).  The Laplace
# kernel finds the mode of log p(x' | x, y') with a fixed-iteration Newton
# solve (vectorized replacement for `scipy.optimize.root_scalar`); the EP
# kernel matches moments by Gauss-Hermite quadrature.
# --------------------------------------------------------------------------

_NEWTON_ITERS = 10
_GH_POINTS = 32


def _laplace_mode(params: SVMParams, x_t, y_next):
    """Mode and curvature of x' -> log p(x'|x) + log p(y'|x')."""
    qinv, rinv = params.qinv, params.rinv
    mean = params.a * x_t[:, 0]
    y2r = (y_next[0] ** 2) * rinv

    def newton(mode, _):
        g = -(mode - mean) * qinv + 0.5 * y2r * jnp.exp(-mode) - 0.5
        h = -qinv - 0.5 * y2r * jnp.exp(-mode)
        return mode - g / h, None

    mode, _ = jax.lax.scan(newton, mean, None, length=_NEWTON_ITERS)
    h = -qinv - 0.5 * y2r * jnp.exp(-mode)
    return mode, -1.0 / h            # (mode, proposal variance)


def _propose_laplace(params: SVMParams, key, x_t, y_next):
    mode, var = _laplace_mode(params, x_t, y_next)
    z = jax.random.normal(key, mode.shape, x_t.dtype)
    return (mode + jnp.sqrt(var) * z)[:, None]


def _reweight_laplace(params: SVMParams, x_t, x_next, y_next):
    """w = p(x'|x) p(y'|x') / q(x'|x, y')."""
    mode, var = _laplace_mode(params, x_t, y_next)
    x1 = x_next[:, 0]
    log_q = (-0.5 * _LOG_2PI - 0.5 * jnp.log(var)
             - 0.5 * (x1 - mode) ** 2 / var)
    return (_prior_log_density(params, x_t, x_next)
            + _reweight(params, x_t, x_next, y_next) - log_q)


def _ep_moments(params: SVMParams, x_t, y_next):
    """Gauss-Hermite moment matching of p(x' | x, y')
    (`custom_kernels.py:77-148` SVMEPKernel)."""
    import numpy as onp
    nodes, weights = onp.polynomial.hermite_e.hermegauss(_GH_POINTS)
    nodes = jnp.asarray(nodes, x_t.dtype)
    gh_w = jnp.asarray(weights, x_t.dtype)
    mean = params.a * x_t[:, 0]
    sd = jnp.sqrt(params.Q)
    xs = mean[:, None] + sd * nodes[None, :]          # [N, G]
    log_lik = (-0.5 * (y_next[0] ** 2) * jnp.exp(-xs) * params.rinv
               - 0.5 * xs)
    w = gh_w[None, :] * jnp.exp(log_lik - jnp.max(log_lik, axis=1,
                                                  keepdims=True))
    w = w / jnp.sum(w, axis=1, keepdims=True)
    m1 = jnp.sum(w * xs, axis=1)
    m2 = jnp.sum(w * xs * xs, axis=1)
    return m1, jnp.maximum(m2 - m1 * m1, 1e-8)


def _propose_ep(params: SVMParams, key, x_t, y_next):
    m1, var = _ep_moments(params, x_t, y_next)
    z = jax.random.normal(key, m1.shape, x_t.dtype)
    return (m1 + jnp.sqrt(var) * z)[:, None]


def _reweight_ep(params: SVMParams, x_t, x_next, y_next):
    m1, var = _ep_moments(params, x_t, y_next)
    x1 = x_next[:, 0]
    log_q = (-0.5 * _LOG_2PI - 0.5 * jnp.log(var)
             - 0.5 * (x1 - m1) ** 2 / var)
    return (_prior_log_density(params, x_t, x_next)
            + _reweight(params, x_t, x_next, y_next) - log_q)


LAPLACE_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_laplace,
    reweight=_reweight_laplace, prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=1)

EP_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_ep, reweight=_reweight_ep,
    prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=1)


def get_kernel(name: str | None = None) -> ParticleKernel:
    """Kernel selection (`svm/helper.py:56-65`), extended with working
    Laplace / EP adaptive proposals."""
    if name in (None, "prior"):
        return KERNEL
    if name == "laplace":
        return LAPLACE_KERNEL
    if name == "ep":
        return EP_KERNEL
    raise ValueError(f"Unrecognized SVM kernel '{name}'")


# --------------------------------------------------------------------------
# Additive statistics (Fisher-identity score), `svm/helper.py:297-350`
# --------------------------------------------------------------------------

STATISTIC_DIM = 3  # [grad_LRinv, grad_LQinv, grad_A]


def grad_statistic(params: SVMParams, x_t, x_next, y_next, t):
    """Per-particle gradient of log Pr(y', x' | x, theta), [N, 3]."""
    x0 = x_t[:, 0]
    x1 = x_next[:, 0]
    diff_x = x1 - params.a * x0
    grad_A = params.qinv * diff_x * x0
    grad_LQinv = 1.0 / params.lqinv - diff_x * diff_x * params.lqinv
    diff_y2 = (y_next[0] ** 2) * jnp.exp(jnp.clip(-x1, -60.0, 60.0))
    grad_LRinv = 1.0 / params.lrinv - diff_y2 * params.lrinv
    return jnp.stack([grad_LRinv, grad_LQinv, grad_A], axis=-1)


def suff_statistic(params: SVMParams, x_t, x_next, y_next, t):
    """(x', x'^2, x x') Gaussian sufficient stats (`lgssm/helper.py:1338`)."""
    x0 = x_t[:, 0]
    x1 = x_next[:, 0]
    return jnp.stack([x1, x1 * x1, x0 * x1], axis=-1)


def latent_moments(params: SVMParams, stats):
    """Elementwise-averaged suff stats [T, 3] -> smoothed/filtered latent
    (mean [T, 1], cov [T, 1, 1]) (`pf_latent_var_distr`,
    `svm/helper.py:249-294`)."""
    x_mean = stats[:, 0]
    x_cov = stats[:, 1] - x_mean ** 2
    return x_mean[:, None], x_cov[:, None, None]


Y_STATISTIC_DIM = 1


def y_statistic(params: SVMParams, x_t, x_next, y_next, t):
    """E[exp(x)] feature for exact observation moments under the emission
    y ~ N(0, exp(x) R).  The reference's `pf_y_distr` is unimplemented
    (`sgmcmc_sampler.py:1930`); this realizes the documented contract."""
    return jnp.exp(jnp.clip(x_next[:, 0], -60.0, 60.0))[:, None]


def y_moments(params: SVMParams, stats):
    """[T, 1] E[exp(x_t) | y] -> (y_mean [T, 1] = 0, y_cov [T, 1, 1] =
    R * E[exp(x_t)]) by the law of total variance."""
    T = stats.shape[0]
    return (jnp.zeros((T, 1), stats.dtype),
            (params.R * stats[:, 0])[:, None, None])


def make_predictive_stat_fn(observations, num_steps_ahead: int,
                            n_mc: int = 1, base_key=None,
                            valid_length=None):
    """k-step-ahead predictive loglikelihood statistic
    (`svm_predictive_loglikelihood`, `svm/helper.py:352-395`): propagate the
    latent AR(1) moments k steps, Monte-Carlo over the latent, and score
    y_{t+k} under N(0, exp(x) R).  Returns [N, num_steps_ahead+1].

    ``valid_length`` (traced scalar, default the static length) masks
    horizons past the true sequence end — used by padded multi-sequence
    batching, where observations beyond ``valid_length`` are padding."""
    T = observations.shape[0]
    T_valid = T if valid_length is None else valid_length
    if base_key is None:
        base_key = jax.random.PRNGKey(0)

    def stat_fn(params, x_t, x_next, y_next, t):
        N = x_next.shape[0]
        a, Q, R = params.a, params.Q, params.R
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
            x_var = Q + a * a * x_var
        return jnp.stack(out, axis=-1)

    return stat_fn


# --------------------------------------------------------------------------
# Fused-kernel bundle (shape-polymorphic elementwise forms of the kernel
# and score above; see `ops/pallas/fused_pf.py`)
# --------------------------------------------------------------------------

def _fused_pack(params: SVMParams) -> jax.Array:
    return jnp.stack([params.a, params.lqinv, params.lrinv])


def _fused_propose(pv, z, x, y_t):
    a, lqinv, _ = pv
    return [a * x[0] + z[0] / lqinv]


def _fused_reweight(pv, x, x_new, y_t):
    _, _, lrinv = pv
    xn = x_new[0]
    return (-0.5 * _LOG_2PI
            - 0.5 * (y_t ** 2) * jnp.exp(jnp.clip(-xn, -60.0, 60.0))
            * (lrinv * lrinv)
            + jnp.log(jnp.abs(lrinv))
            - 0.5 * xn)


def _fused_stat(pv, x, x_new, y_t):
    a, lqinv, lrinv = pv
    x0, x1 = x[0], x_new[0]
    diff_x = x1 - a * x0
    grad_A = (lqinv * lqinv) * diff_x * x0
    grad_LQinv = 1.0 / lqinv - diff_x * diff_x * lqinv
    diff_y2 = (y_t ** 2) * jnp.exp(jnp.clip(-x1, -60.0, 60.0))
    grad_LRinv = 1.0 / lrinv - diff_y2 * lrinv
    return [grad_LRinv, grad_LQinv, grad_A]   # STATISTIC_DIM order


def _make_fused():
    from ..ops.pallas.fused_pf import FusedModel
    return FusedModel(n_state=1, n_stat=STATISTIC_DIM, n_param=3,
                      pack_params=_fused_pack, propose=_fused_propose,
                      reweight=_fused_reweight, stat=_fused_stat)


FUSED = _make_fused()


def get_fused(name: str | None = None):
    """Fused bundle matching `get_kernel` (bootstrap/prior only; the
    Laplace/EP proposals stay on the unfused path)."""
    return FUSED if name in (None, "prior") else None


def unpack_grad(stat: jax.Array) -> SVMParams:
    """Score vector [3] -> gradient pytree (`svm/helper.py:121-126`)."""
    return SVMParams(
        A=stat[2].reshape(1, 1),
        LQinv_vec=stat[1].reshape(1),
        LRinv_vec=stat[0].reshape(1),
    )


# --------------------------------------------------------------------------
# Prior, `svm/parameters.py:63-73` (Wishart on Qinv/Rinv, matrix-normal on A)
# --------------------------------------------------------------------------

@pytree.dataclass
class SVMPrior:
    """Hyperparameters (`CovariancePriorHelper`/`SquareMatrixPriorHelper`)."""
    mean_A: jax.Array        # (1, 1)
    var_col_A: jax.Array     # (1,)
    scale_Qinv: jax.Array    # (1, 1)
    df_Qinv: jax.Array       # ()
    scale_Rinv: jax.Array    # (1, 1)
    df_Rinv: jax.Array       # ()


def default_prior(var: float = 100.0, dtype=jnp.float32) -> SVMPrior:
    """`generate_default_prior` semantics (`base_parameters.py:207-213`,
    helper defaults `matrices.py` / `covariance.py:275-284`).
    Host-NumPy leaves (no eager device dispatch)."""
    import numpy as onp
    npdtype = onp.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    df = 2.0 + 1.0 / var
    return SVMPrior(
        mean_A=onp.zeros((1, 1), npdtype),
        var_col_A=onp.full((1,), var, npdtype),
        scale_Qinv=onp.full((1, 1), 1.0 / df, npdtype),
        df_Qinv=onp.asarray(df, npdtype),
        scale_Rinv=onp.full((1, 1), 1.0 / df, npdtype),
        df_Rinv=onp.asarray(df, npdtype),
    )


def logprior(prior: SVMPrior, params: SVMParams) -> jax.Array:
    LQinv = tril_vector_to_mat(params.LQinv_vec)
    LRinv = tril_vector_to_mat(params.LRinv_vec)
    Qinv = LQinv @ LQinv.T
    Rinv = LRinv @ LRinv.T
    lp = wishart_logpdf(Qinv, prior.df_Qinv, prior.scale_Qinv)
    lp += wishart_logpdf(Rinv, prior.df_Rinv, prior.scale_Rinv)
    lp += matrix_normal_logpdf(
        params.A, prior.mean_A, Lrowprec=LQinv,
        Lcolprec=jnp.diag(prior.var_col_A ** -0.5))
    return lp


def grad_logprior(prior: SVMPrior, params: SVMParams) -> SVMParams:
    """Analytic prior score in the (A, LQinv_vec, LRinv_vec) coordinates.

    Matches `covariance.py:252-260` and `matrices.py:602-612` exactly —
    including the reference's convention that the matrix-normal prior on A
    contributes no gradient to LQinv (its row covariance is treated as
    constant), so this is the gradient of the *partial* logprior the
    reference samplers target.
    """
    lqinv, lrinv = params.lqinv, params.lrinv
    n = 1
    grad_LQinv = ((prior.df_Qinv - n - 1) / lqinv
                  - lqinv / prior.scale_Qinv[0, 0])
    grad_LRinv = ((prior.df_Rinv - n - 1) / lrinv
                  - lrinv / prior.scale_Rinv[0, 0])
    grad_A = -params.qinv * (params.A - prior.mean_A) / prior.var_col_A
    return SVMParams(A=grad_A,
                     LQinv_vec=grad_LQinv.reshape(1),
                     LRinv_vec=grad_LRinv.reshape(1))


def sample_prior(prior: SVMPrior, key) -> SVMParams:
    kq, kr, ka = jax.random.split(key, 3)
    Qinv = sample_wishart(kq, prior.df_Qinv, prior.scale_Qinv)
    Rinv = sample_wishart(kr, prior.df_Rinv, prior.scale_Rinv)
    lqinv = jnp.sqrt(Qinv[0, 0])
    lrinv = jnp.sqrt(Rinv[0, 0])
    # A | Q ~ MN(mean, Q, diag(var_col)) for the scalar case
    a_sd = jnp.sqrt(prior.var_col_A[0]) / lqinv
    A = prior.mean_A + a_sd * jax.random.normal(ka, (1, 1), lqinv.dtype)
    return SVMParams(A=A, LQinv_vec=lqinv.reshape(1),
                     LRinv_vec=lrinv.reshape(1))


# --------------------------------------------------------------------------
# Projection (`svm/parameters.py` via variable helpers)
# --------------------------------------------------------------------------

def project_parameters(params: SVMParams, a_threshold: float = 0.9999) -> SVMParams:
    """|A| <= threshold; reflect negative Cholesky diagonals
    (`matrices.py:465-478`, `covariance.py:64-81`)."""
    return SVMParams(
        A=jnp.clip(params.A, -a_threshold, a_threshold),
        LQinv_vec=jnp.abs(params.LQinv_vec),
        LRinv_vec=jnp.abs(params.LRinv_vec),
    )


# --------------------------------------------------------------------------
# Data generation (`svm/parameters.py:75-135`)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("T",))
def generate_data(key, params: SVMParams, T: int):
    """Simulate (observations [T, 1], latent [T, 1]) from the SVM."""
    k0, kx, ky = jax.random.split(key, 3)
    x0 = jnp.sqrt(stationary_variance(params)) * jax.random.normal(
        k0, (), dtype=params.A.dtype)
    zx = jax.random.normal(kx, (T,), dtype=params.A.dtype)
    zy = jax.random.normal(ky, (T,), dtype=params.A.dtype)

    def body(x_prev, z):
        zx_t, zy_t = z
        x = params.a * x_prev + jnp.sqrt(params.Q) * zx_t
        y = jnp.exp(0.5 * x) * jnp.sqrt(params.R) * zy_t
        return x, (x, y)

    _, (xs, ys) = jax.lax.scan(body, x0, (zx, zy))
    return ys[:, None], xs[:, None]
