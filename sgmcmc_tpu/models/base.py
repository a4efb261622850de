"""Model abstraction for the SG-MCMC framework.

The reference implements particle kernels as *stateful* objects mutated per
timestep (`/root/reference/sgmcmc_ssm/particle_filters/kernels.py:9-21`:
``set_parameters`` / ``set_y_next``).  Here the same contract is a bundle of
*pure functions* over a frozen parameter pytree, so the whole particle
filter/smoother compiles to a single ``lax.scan`` and vmaps over particles,
subsequences, and chains.

A :class:`ParticleKernel` is what the PF engine needs; a model module
additionally supplies parameter pytrees (dataclasses), priors with
``grad_logprior``, preconditioners, projection maps, additive-statistic
functions, and (for LGSSM/HMM) exact message-passing oracles.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax

# Signatures (Params is a model-specific pytree; arrays use [N, D] particles):
#   sample_x0(params, key, n_particles, prior_mean, prior_var) -> x0 [N, D]
#   propose(params, key, x_t [N, D], y_next [m]) -> x_next [N, D]
#   reweight(params, x_t [N, D], x_next [N, D], y_next [m]) -> log_w [N]
#   prior_log_density(params, x_t [..., D], x_next [..., D]) -> [...]
#   prior_log_density_max(params) -> scalar
#
# StatisticFn (additive statistics h_t, reference `pf.py` smoothers):
#   stat_fn(params, x_t [N, D], x_next [N, D], y_next [m], t) -> [N, H]


@dataclasses.dataclass(frozen=True)
class ParticleKernel:
    """Pure-function particle kernel (propose/reweight/backward-density).

    Functional twin of the reference `Kernel` ABC
    (`particle_filters/kernels.py:9-79`); instances are static (hashable)
    and closed over by jitted scans.
    """
    sample_x0: Callable[..., jax.Array]
    propose: Callable[..., jax.Array]
    reweight: Callable[..., jax.Array]
    prior_log_density: Callable[..., jax.Array]
    prior_log_density_max: Callable[..., jax.Array]
    # latent-state dimension carried by the PF (GARCH carries (x, sigma^2) -> 2)
    state_dim: int = 1

    def __hash__(self):  # allow use as a static argument to jax.jit
        return hash((self.sample_x0, self.propose, self.reweight,
                     self.prior_log_density, self.prior_log_density_max,
                     self.state_dim))


StatisticFn = Callable[..., jax.Array]
Params = Any
