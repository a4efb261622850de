"""Resampling kernels for particle filters.

The reference resamples with ``np.random.choice`` (multinomial,
`/root/reference/sgmcmc_ssm/particle_filters/pf.py:27-30`).  We provide three
jittable, vmappable schemes:

* ``multinomial`` — statistical parity with the reference (categorical via
  Gumbel-max, O(N log N) on-device but fully vectorized).
* ``systematic`` — sorted-uniform inverse-CDF gather; lowest variance and the
  scheme of the fused window kernel (`ops/pallas/fused_pf.py`).
* ``stratified`` — one uniform per stratum.

All return int32 ancestor indices of shape (N,) given log-weights (N,).
`resample_apply` instead resamples a joint value matrix in one gather
(the smoothers' ``resample_mode='auto'`` form of the same schemes).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def normalize_log_weights(log_weights: jax.Array) -> jax.Array:
    """exp-normalize log weights to probabilities (`pf.py:374-377`).

    Degenerate inputs (all -inf / non-finite) fall back to uniform weights
    instead of propagating NaN through the filter.
    """
    m = jnp.max(log_weights, axis=-1, keepdims=True)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    w = jnp.exp(log_weights - m)
    total = jnp.sum(w, axis=-1, keepdims=True)
    n = log_weights.shape[-1]
    return jnp.where(total > 0, w / jnp.where(total > 0, total, 1.0),
                     1.0 / n)


# Above this N, `jax.random.categorical(key, lw, shape=(n,))` is replaced by
# iid-uniform inverse-CDF sampling (identical in law): the categorical path
# materializes an [n, N] Gumbel block — 400 MB at N=1e4, a device-crashing
# 4 TB at the reference's N=1e6 ground-truth configs (`svm_grad_compare.py:75`).
_CATEGORICAL_MAX_N = 8192


def multinomial_resampling(key: jax.Array, log_weights: jax.Array,
                           num_samples: int | None = None) -> jax.Array:
    """Categorical ancestor sampling, matching np.random.choice in law.

    Small N uses Gumbel-max `jax.random.categorical`; large N draws iid
    uniforms through the inverse CDF (O(n log N) binary search, O(n + N)
    memory) — both are exact multinomial sampling, only the PRNG-to-index
    map differs.
    """
    n = log_weights.shape[-1] if num_samples is None else num_samples
    if max(n, log_weights.shape[-1]) <= _CATEGORICAL_MAX_N:
        return jax.random.categorical(key, log_weights,
                                      shape=(n,)).astype(jnp.int32)
    u = jax.random.uniform(key, (n,), dtype=log_weights.dtype)
    return _inverse_cdf_gather(u, log_weights)


def _inverse_cdf_gather(positions: jax.Array, log_weights: jax.Array) -> jax.Array:
    """Map positions in [0,1) to indices via the weight CDF (positions need
    not be sorted; the binary search is per-query)."""
    probs = normalize_log_weights(log_weights)
    cdf = jnp.cumsum(probs, axis=-1)
    # searchsorted is XLA-lowered to a vectorized binary search.
    idx = jnp.searchsorted(cdf, positions, side="left")
    return jnp.clip(idx, 0, log_weights.shape[-1] - 1).astype(jnp.int32)


def systematic_resampling(key: jax.Array, log_weights: jax.Array,
                          num_samples: int | None = None) -> jax.Array:
    """Systematic (single-uniform comb) resampling."""
    n = log_weights.shape[-1] if num_samples is None else num_samples
    u0 = jax.random.uniform(key, (), dtype=log_weights.dtype)
    positions = (jnp.arange(n, dtype=log_weights.dtype) + u0) / n
    return _inverse_cdf_gather(positions, log_weights)


def stratified_resampling(key: jax.Array, log_weights: jax.Array,
                          num_samples: int | None = None) -> jax.Array:
    """Stratified (one uniform per stratum) resampling."""
    n = log_weights.shape[-1] if num_samples is None else num_samples
    u = jax.random.uniform(key, (n,), dtype=log_weights.dtype)
    positions = (jnp.arange(n, dtype=log_weights.dtype) + u) / n
    return _inverse_cdf_gather(positions, log_weights)


RESAMPLERS = {
    "multinomial": multinomial_resampling,
    "systematic": systematic_resampling,
    "stratified": stratified_resampling,
}


def get_resampler(name: str):
    if name not in RESAMPLERS:
        raise ValueError(f"Unrecognized resampler '{name}'; "
                         f"choose from {sorted(RESAMPLERS)}")
    return RESAMPLERS[name]


def effective_sample_size(log_weights: jax.Array) -> jax.Array:
    """ESS = 1 / sum(w_i^2) of the normalized weights."""
    w = normalize_log_weights(log_weights)
    return 1.0 / jnp.sum(w * w, axis=-1)


# --------------------------------------------------------------------------
# Resample-apply: resample the rows of a joint [N, K] value matrix
# --------------------------------------------------------------------------

def weights_cdf(log_weights: jax.Array) -> jax.Array:
    """Inclusive CDF of exp(log_weights), normalized by its last entry;
    degenerate (all -inf) weight vectors fall back to the uniform CDF
    instead of NaN."""
    m = jnp.max(log_weights)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    cdf = jnp.cumsum(jnp.exp(log_weights - m))
    n = log_weights.shape[0]
    uniform = jnp.arange(1, n + 1, dtype=cdf.dtype) / n
    return jnp.where(cdf[-1] > 0, cdf / jnp.where(cdf[-1] > 0, cdf[-1], 1.0),
                     uniform)


def resample_positions(scheme: str, key: jax.Array, n: int, dtype):
    """Resampling positions u [n] in [0, 1) for each scheme."""
    if scheme == "multinomial":
        return jax.random.uniform(key, (n,), dtype)
    if scheme == "systematic":
        u0 = jax.random.uniform(key, (), dtype)
        return (jnp.arange(n, dtype=dtype) + u0) / n
    if scheme == "stratified":
        u = jax.random.uniform(key, (n,), dtype)
        return (jnp.arange(n, dtype=dtype) + u) / n
    raise ValueError(f"Unrecognized resampling scheme '{scheme}'")


def resample_apply(key: jax.Array, log_weights: jax.Array, vals: jax.Array,
                   scheme: str = "systematic") -> jax.Array:
    """Resample rows of ``vals`` [N, K] according to ``log_weights``:
    row i of the result is ``vals[#{j : cdf_j <= u_i}]`` (clipped)."""
    cdf = weights_cdf(log_weights)
    pos = resample_positions(scheme, key, log_weights.shape[0], cdf.dtype)
    idx = jnp.clip(jnp.searchsorted(cdf, pos, side="right"),
                   0, vals.shape[0] - 1)
    return jnp.take(vals, idx, axis=0)
