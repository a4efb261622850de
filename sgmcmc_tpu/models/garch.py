"""GARCH(1,1)-with-observation-noise model.

sigma2_t = alpha + beta x_{t-1}^2 + gamma sigma2_{t-1},
x_t ~ N(0, sigma2_t),   y_t = x_t + N(0, R)

Functional rewrite of `/root/reference/sgmcmc_ssm/models/garch/`.  Natural
parameters are stored unconstrained — ``log_mu``, ``logit_phi``,
``logit_lambduh`` (`variables/garch_var.py:21-91`) with
``alpha = mu (1-phi)``, ``beta = phi lambduh``, ``gamma = phi (1-lambduh)``
— and the particle state is 2-D ``(x_t, sigma2_t)``, carrying the variance
recursion deterministically (`garch/kernels.py:5-18`).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from ..utils import pytree

from ..utils.distributions import beta_logpdf, invgamma_logpdf
from .base import ParticleKernel

_LOG_2PI = 1.8378770664093453


@pytree.dataclass
class GARCHParams:
    """GARCH parameter pytree (unconstrained reference coordinates)."""
    log_mu: jax.Array         # (1,)
    logit_phi: jax.Array      # (1,)
    logit_lambduh: jax.Array  # (1,)
    LRinv_vec: jax.Array      # (1,)

    @property
    def mu(self):
        return jnp.exp(self.log_mu[0])

    @property
    def phi(self):
        return jax.nn.sigmoid(self.logit_phi[0])

    @property
    def lambduh(self):
        return jax.nn.sigmoid(self.logit_lambduh[0])

    @property
    def alpha(self):
        return self.mu * (1.0 - self.phi)

    @property
    def beta(self):
        return self.phi * self.lambduh

    @property
    def gamma(self):
        return self.phi * (1.0 - self.lambduh)

    @property
    def lrinv(self):
        return self.LRinv_vec[0]

    @property
    def rinv(self):
        return self.lrinv ** 2

    @property
    def R(self):
        return 1.0 / self.rinv

    @property
    def tau(self):
        return 1.0 / jnp.abs(self.lrinv)


def from_alpha_beta_gamma(alpha, beta, gamma, R, dtype=jnp.float32
                          ) -> GARCHParams:
    """Natural (alpha, beta, gamma, R) -> unconstrained storage
    (`garch/parameters.py:45-60` convert_alpha_beta_gamma).
    Host-NumPy leaves (no eager device dispatch)."""
    import numpy as np
    npdtype = np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    phi = beta + gamma
    mu = alpha / (1.0 - phi)
    lambduh = beta / phi
    return GARCHParams(
        log_mu=np.full((1,), float(np.log(mu)), npdtype),
        logit_phi=np.full((1,), float(np.log(phi / (1 - phi))), npdtype),
        logit_lambduh=np.full((1,), float(np.log(lambduh / (1 - lambduh))),
                              npdtype),
        LRinv_vec=np.full((1,), float(R) ** -0.5, npdtype),
    )


def stationary_variance(params: GARCHParams) -> jax.Array:
    """Stationary variance of x: alpha / (1 - beta - gamma)
    (`garch/helper.py:324-332`)."""
    return params.alpha / (1.0 - params.beta - params.gamma)


def _sigma2_next(params: GARCHParams, x_t):
    """Variance recursion; x_t is [N, 2] = (x, sigma2)."""
    return (params.alpha + params.beta * x_t[:, 0] ** 2
            + params.gamma * x_t[:, 1])


# --------------------------------------------------------------------------
# Particle kernels (`garch/kernels.py`)
# --------------------------------------------------------------------------

def _sample_x0(params: GARCHParams, key, n_particles, prior_mean, prior_var):
    dtype = params.log_mu.dtype
    z = jax.random.normal(key, (n_particles,), dtype)
    x = prior_mean + jnp.sqrt(prior_var) * z
    return jnp.stack([x, jnp.zeros_like(x)], axis=-1)


def _propose_prior(params: GARCHParams, key, x_t, y_next):
    s2 = _sigma2_next(params, x_t)
    z = jax.random.normal(key, s2.shape, s2.dtype)
    return jnp.stack([jnp.sqrt(s2) * z, s2], axis=-1)


def _reweight_prior(params: GARCHParams, x_t, x_next, y_next):
    diff = y_next[0] - x_next[:, 0]
    return (-0.5 * _LOG_2PI - 0.5 * diff * diff * params.rinv
            + jnp.log(jnp.abs(params.lrinv)))


def _propose_optimal(params: GARCHParams, key, x_t, y_next):
    """x' ~ p(x' | x, y') (`GARCHOptimalKernel.rv`,
    `garch/kernels.py:136-158`)."""
    s2 = _sigma2_next(params, x_t)
    var = 1.0 / (params.rinv + 1.0 / s2)
    mean = var * (y_next[0] * params.rinv)
    z = jax.random.normal(key, s2.shape, s2.dtype)
    return jnp.stack([mean + jnp.sqrt(var) * z, s2], axis=-1)


def _reweight_optimal(params: GARCHParams, x_t, x_next, y_next):
    """log p(y' | x) = log N(y'; 0, sigma2' + R)."""
    var = x_next[:, 1] + params.R
    return (-0.5 * _LOG_2PI - 0.5 * (y_next[0] ** 2) / var
            - 0.5 * jnp.log(var))


def _prior_log_density(params: GARCHParams, x_t, x_next):
    s2 = params.alpha + params.beta * x_t[..., 0] ** 2 + params.gamma * x_t[..., 1]
    return (-0.5 * x_next[..., 0] ** 2 / s2 - 0.5 * _LOG_2PI
            - 0.5 * jnp.log(s2))


def _prior_log_density_max(params: GARCHParams):
    return -0.5 * _LOG_2PI - 0.5 * jnp.log(params.alpha)


PRIOR_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_prior, reweight=_reweight_prior,
    prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=2)

OPTIMAL_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_optimal,
    reweight=_reweight_optimal, prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=2)


def get_kernel(name: str | None = None) -> ParticleKernel:
    """Default is the optimal kernel (`garch/helper.py:48-57`)."""
    if name in (None, "optimal"):
        return OPTIMAL_KERNEL
    if name == "prior":
        return PRIOR_KERNEL
    raise ValueError(f"Unrecognized GARCH kernel '{name}'")


# --------------------------------------------------------------------------
# Additive statistics (`garch/helper.py:335-430`)
# --------------------------------------------------------------------------

STATISTIC_DIM = 4  # [grad_LRinv, grad_log_mu, grad_logit_phi, grad_logit_lambduh]


def grad_statistic(params: GARCHParams, x_t, x_next, y_next, t):
    """Per-particle chain-rule score in the unconstrained coordinates."""
    mu, phi, lam = params.mu, params.phi, params.lambduh
    v = x_next[:, 1]
    grad_v = -0.5 * (v - x_next[:, 0] ** 2) / (v * v)
    grad_log_mu = grad_v * (1.0 - phi) * mu
    grad_logit_phi = (grad_v
                      * (-mu + lam * x_t[:, 0] ** 2 + (1.0 - lam) * x_t[:, 1])
                      * (1.0 - phi) * phi)
    grad_logit_lambduh = (grad_v * phi * (x_t[:, 0] ** 2 - x_t[:, 1])
                          * (1.0 - lam) * lam)
    diff_y = y_next[0] - x_next[:, 0]
    grad_LRinv = 1.0 / params.lrinv - diff_y * diff_y * params.lrinv
    return jnp.stack([grad_LRinv, grad_log_mu, grad_logit_phi,
                      grad_logit_lambduh], axis=-1)


def suff_statistic(params: GARCHParams, x_t, x_next, y_next, t):
    """(x', x'^2, x'^4) (`garch/helper.py:414-430`)."""
    x1 = x_next[:, 0]
    return jnp.stack([x1, x1 * x1, x1 ** 4], axis=-1)


def latent_moments(params: GARCHParams, stats, squared: bool = False):
    """Elementwise-averaged suff stats [T, 3] -> latent (mean, cov).

    ``squared`` returns the moments of x^2 instead (the reference's
    data-fit view, `garch/helper.py:262-267`)."""
    if squared:
        x_mean = stats[:, 1]
        x_cov = stats[:, 2] - x_mean ** 2
    else:
        x_mean = stats[:, 0]
        x_cov = stats[:, 1] - x_mean ** 2
    return x_mean[:, None], x_cov[:, None, None]


Y_STATISTIC_DIM = 2


def y_statistic(params: GARCHParams, x_t, x_next, y_next, t):
    """(x, x^2) features for observation moments under y = x + N(0, R)."""
    x1 = x_next[:, 0]
    return jnp.stack([x1, x1 * x1], axis=-1)


def y_moments(params: GARCHParams, stats):
    """[T, 2] (E[x], E[x^2]) -> (y_mean [T,1] = E[x],
    y_cov [T,1,1] = Var[x] + R)."""
    x_mean = stats[:, 0]
    y_cov = stats[:, 1] - x_mean ** 2 + params.R
    return x_mean[:, None], y_cov[:, None, None]


def make_predictive_stat_fn(observations, num_steps_ahead: int,
                            base_key=None, valid_length=None):
    """k-step-ahead predictive loglikelihood statistic
    (`garch_predictive_loglikelihood`, `garch/helper.py:374-412`):
    forward-simulate particles through the prior kernel and score y_{t+k}
    under N(x_pred, R).  Returns [N, num_steps_ahead+1].

    ``valid_length`` (traced scalar) masks horizons past the true sequence
    end for padded multi-sequence batching."""
    T = observations.shape[0]
    T_valid = T if valid_length is None else valid_length
    if base_key is None:
        base_key = jax.random.PRNGKey(0)

    def stat_fn(params, x_t, x_next, y_next, t):
        R = params.R
        out = []
        x_pred = x_next
        for k in range(num_steps_ahead + 1):
            tk = jnp.clip(t + k, 0, T - 1)
            in_range = (t + k < T_valid).astype(x_pred.dtype)
            diff = observations[tk, 0] - x_pred[:, 0]
            ll = (-0.5 * diff * diff / R - 0.5 * _LOG_2PI
                  - 0.5 * jnp.log(R))
            out.append(in_range * ll)
            k_prop = jax.random.fold_in(jax.random.fold_in(base_key, k), 1)
            x_pred = _propose_prior(params, k_prop, x_pred, y_next)
        return jnp.stack(out, axis=-1)

    return stat_fn


# --------------------------------------------------------------------------
# Fused-kernel bundles (shape-polymorphic elementwise forms; see
# `ops/pallas/fused_pf.py`).  State is [x, sigma2]; sigma2 is the
# deterministically-carried second component (`garch/kernels.py:5-18`).
# --------------------------------------------------------------------------

def _fused_pack(params: GARCHParams) -> jax.Array:
    return jnp.stack([params.mu, params.phi, params.lambduh, params.lrinv])


def _fused_abg(pv):
    mu, phi, lam, lrinv = pv
    alpha = mu * (1.0 - phi)
    beta = phi * lam
    gamma = phi * (1.0 - lam)
    return alpha, beta, gamma, lrinv


def _fused_init(z, prior_mean, prior_var):
    return [prior_mean + jnp.sqrt(prior_var) * z[0],
            jnp.zeros_like(z[0])]


def _fused_propose_optimal(pv, z, x, y_t):
    alpha, beta, gamma, lrinv = _fused_abg(pv)
    s2 = alpha + beta * x[0] ** 2 + gamma * x[1]
    rinv = lrinv * lrinv
    var = 1.0 / (rinv + 1.0 / s2)
    mean = var * (y_t * rinv)
    return [mean + jnp.sqrt(var) * z[0], s2]


def _fused_reweight_optimal(pv, x, x_new, y_t):
    _, _, _, lrinv = _fused_abg(pv)
    var = x_new[1] + 1.0 / (lrinv * lrinv)
    return (-0.5 * _LOG_2PI - 0.5 * (y_t ** 2) / var - 0.5 * jnp.log(var))


def _fused_propose_prior(pv, z, x, y_t):
    alpha, beta, gamma, _ = _fused_abg(pv)
    s2 = alpha + beta * x[0] ** 2 + gamma * x[1]
    return [jnp.sqrt(s2) * z[0], s2]


def _fused_reweight_prior(pv, x, x_new, y_t):
    _, _, _, lrinv = _fused_abg(pv)
    diff = y_t - x_new[0]
    return (-0.5 * _LOG_2PI - 0.5 * diff * diff * (lrinv * lrinv)
            + jnp.log(jnp.abs(lrinv)))


def _fused_stat(pv, x, x_new, y_t):
    mu, phi, lam, lrinv = pv
    v = x_new[1]
    grad_v = -0.5 * (v - x_new[0] ** 2) / (v * v)
    grad_log_mu = grad_v * (1.0 - phi) * mu
    grad_logit_phi = (grad_v
                      * (-mu + lam * x[0] ** 2 + (1.0 - lam) * x[1])
                      * (1.0 - phi) * phi)
    grad_logit_lambduh = grad_v * phi * (x[0] ** 2 - x[1]) * (1.0 - lam) * lam
    diff_y = y_t - x_new[0]
    grad_LRinv = 1.0 / lrinv - diff_y * diff_y * lrinv
    return [grad_LRinv, grad_log_mu, grad_logit_phi, grad_logit_lambduh]


def _make_fused():
    from ..ops.pallas.fused_pf import FusedModel
    common = dict(n_state=2, n_stat=STATISTIC_DIM, n_param=4,
                  pack_params=_fused_pack, stat=_fused_stat,
                  init=_fused_init, n_noise=1)
    return (FusedModel(propose=_fused_propose_optimal,
                       reweight=_fused_reweight_optimal, **common),
            FusedModel(propose=_fused_propose_prior,
                       reweight=_fused_reweight_prior, **common))


FUSED, FUSED_PRIOR = _make_fused()


def get_fused(name: str | None = None):
    """Fused bundle matching `get_kernel`."""
    if name in (None, "optimal"):
        return FUSED
    if name == "prior":
        return FUSED_PRIOR
    raise ValueError(f"Unrecognized GARCH kernel '{name}'")


def unpack_grad(stat: jax.Array) -> GARCHParams:
    """Score vector [4] -> gradient pytree (`garch/helper.py:110-115`)."""
    return GARCHParams(
        log_mu=stat[1].reshape(1),
        logit_phi=stat[2].reshape(1),
        logit_lambduh=stat[3].reshape(1),
        LRinv_vec=stat[0].reshape(1),
    )


# --------------------------------------------------------------------------
# Prior (`variables/garch_var.py:93-189`): InvGamma(mu), Beta(phi), Beta(lam)
# plus Wishart on Rinv (`garch/parameters.py`)
# --------------------------------------------------------------------------

@pytree.dataclass
class GARCHPrior:
    scale_mu: jax.Array
    shape_mu: jax.Array
    alpha_phi: jax.Array
    beta_phi: jax.Array
    alpha_lambduh: jax.Array
    beta_lambduh: jax.Array
    scale_Rinv: jax.Array    # (1, 1)
    df_Rinv: jax.Array


def default_prior(var: float = 1.0, dtype=jnp.float32) -> GARCHPrior:
    """`get_default_kwargs` (`garch_var.py:179-189`): var capped at 1.
    Host-NumPy leaves (no eager device dispatch)."""
    import numpy as np
    npdtype = np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    var = min(var, 1.0)
    scale_mu = var + 2.0
    alpha = 1.0 + 19.0 / var
    df_r = 2.0 + 1.0 / var
    return GARCHPrior(
        scale_mu=np.asarray(scale_mu, npdtype),
        shape_mu=np.asarray(scale_mu + 1.0, npdtype),
        alpha_phi=np.asarray(alpha, npdtype),
        beta_phi=np.asarray(alpha / 9.0, npdtype),
        alpha_lambduh=np.asarray(alpha, npdtype),
        beta_lambduh=np.asarray(alpha / 9.0, npdtype),
        scale_Rinv=np.full((1, 1), 1.0 / df_r, npdtype),
        df_Rinv=np.asarray(df_r, npdtype),
    )


def logprior(prior: GARCHPrior, params: GARCHParams) -> jax.Array:
    """Note the reference evaluates the Beta densities at (1+phi)/2
    (`garch_var.py:137-150`); mirrored here for parity."""
    from ..utils.distributions import wishart_logpdf
    lp = invgamma_logpdf(params.mu, prior.shape_mu, prior.scale_mu)
    lp += beta_logpdf((1.0 + params.phi) / 2.0, prior.alpha_phi,
                      prior.beta_phi)
    lp += beta_logpdf((1.0 + params.lambduh) / 2.0, prior.alpha_lambduh,
                      prior.beta_lambduh)
    Rinv = jnp.asarray([[params.rinv]])
    lp += wishart_logpdf(Rinv, prior.df_Rinv, prior.scale_Rinv)
    return lp


def grad_logprior(prior: GARCHPrior, params: GARCHParams) -> GARCHParams:
    """Hand-derived unconstrained-space prior score
    (`garch_var.py:152-165`, `covariance.py:252-260`)."""
    mu, phi, lam = params.mu, params.phi, params.lambduh
    g_log_mu = -prior.shape_mu - 1.0 + prior.scale_mu / mu
    g_logit_phi = ((prior.alpha_phi - 1.0) / (1.0 + phi)
                   - (prior.beta_phi - 1.0) / (1.0 - phi)) * phi * (1.0 - phi)
    g_logit_lam = ((prior.alpha_lambduh - 1.0) / (1.0 + lam)
                   - (prior.beta_lambduh - 1.0) / (1.0 - lam)) * lam * (1.0 - lam)
    g_lrinv = ((prior.df_Rinv - 2.0) / params.lrinv
               - params.lrinv / prior.scale_Rinv[0, 0])
    return GARCHParams(
        log_mu=g_log_mu.reshape(1),
        logit_phi=g_logit_phi.reshape(1),
        logit_lambduh=g_logit_lam.reshape(1),
        LRinv_vec=g_lrinv.reshape(1),
    )


def sample_prior(prior: GARCHPrior, key) -> GARCHParams:
    from ..utils.distributions import sample_beta, sample_invgamma, sample_wishart
    km, kp, kl, kr = jax.random.split(key, 4)
    dtype = prior.scale_mu.dtype
    mu = sample_invgamma(km, prior.shape_mu, prior.scale_mu, dtype)
    phi = sample_beta(kp, prior.alpha_phi, prior.beta_phi, dtype)
    lam = sample_beta(kl, prior.alpha_lambduh, prior.beta_lambduh, dtype)
    Rinv = sample_wishart(kr, prior.df_Rinv, prior.scale_Rinv)
    return GARCHParams(
        log_mu=jnp.log(mu).reshape(1),
        logit_phi=jax.scipy.special.logit(phi).reshape(1),
        logit_lambduh=jax.scipy.special.logit(lam).reshape(1),
        LRinv_vec=jnp.sqrt(Rinv[0, 0]).reshape(1),
    )


def project_parameters(params: GARCHParams) -> GARCHParams:
    """Unconstrained storage needs no projection beyond reflecting LRinv
    (`garch_var.py:35-40`)."""
    return params.replace(LRinv_vec=jnp.abs(params.LRinv_vec))


# --------------------------------------------------------------------------
# Data generation (`garch/parameters.py:74-139`)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("T",))
def generate_data(key, params: GARCHParams, T: int):
    """Simulate (observations [T, 1], latent x [T, 1])."""
    dtype = params.log_mu.dtype
    kx, ky = jax.random.split(key)
    zx = jax.random.normal(kx, (T,), dtype)
    zy = jax.random.normal(ky, (T,), dtype)
    sigma_y = jnp.sqrt(params.R)

    def body(carry, z):
        x_prev, s2_prev = carry
        zx_t, zy_t = z
        s2 = params.alpha + params.beta * x_prev ** 2 + params.gamma * s2_prev
        x = jnp.sqrt(s2) * zx_t
        y = x + sigma_y * zy_t
        return (x, s2), (x, y)

    init = (jnp.sqrt(stationary_variance(params)) * jax.random.normal(
        jax.random.fold_in(key, 2), (), dtype), stationary_variance(params))
    _, (xs, ys) = jax.lax.scan(body, init, (zx, zy))
    return ys[:, None], xs[:, None]
