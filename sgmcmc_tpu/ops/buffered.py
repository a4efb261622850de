"""Buffered particle filter/smoother wrapper — the hot loop, as one scan.

Replacement for `pf_wrapper` / `buffered_pf_wrapper`
(`/root/reference/sgmcmc_ssm/particle_filters/buffered_smoother.py:12-199`):
the reference's per-timestep Python loop with kernel mutation and
function-swapping becomes a single ``lax.scan`` over a fixed-length window,
with the buffer logic expressed as per-step multiplicative weights
(``0`` off-window, the unbiasedness weight ``w_t`` in-window).  The whole
thing jits once and vmaps over (minibatch subsequences, chains).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.base import ParticleKernel, StatisticFn
from .resampling import normalize_log_weights
from .smoothers import PFCarry, PFStepInput, make_smoother_step


class PFOutput(NamedTuple):
    statistics: jax.Array         # [N, H] (smoothers) / [H] (filter)
    log_weights: jax.Array        # [N]
    particles: jax.Array          # [N, D]
    loglikelihood: jax.Array      # scalar
    mean_statistic: jax.Array     # [H] weight-averaged final statistic


def average_statistic(statistics: jax.Array, log_weights: jax.Array) -> jax.Array:
    """Weight-averaged final statistic (`buffered_smoother.py:151-154`)."""
    if statistics.ndim == 1:
        return statistics
    probs = normalize_log_weights(log_weights)
    return jnp.sum(statistics * probs[:, None], axis=0)


def elementwise_statistic_fn(stat_fn: StatisticFn, t1, length: int,
                             statistic_dim: int) -> StatisticFn:
    """Scatter each step's statistic into its own [t - t1] slice.

    Equivalent of `elementwise_statistic_wrapper`
    (`buffered_smoother.py:201-210`), with the shift done by a one-hot
    scatter so it traces with a dynamic ``t1``.
    """
    def wrapped(params, x_t, x_next, y_next, t):
        h = stat_fn(params, x_t, x_next, y_next, t)     # [N, H]
        slot = jnp.clip(t - t1, 0, length - 1)
        onehot = jax.nn.one_hot(slot, length, dtype=h.dtype)   # [L]
        out = onehot[None, :, None] * h[:, None, :]            # [N, L, H]
        return out.reshape(h.shape[0], length * statistic_dim)

    return wrapped


def run_buffered_pf(
        kernel: ParticleKernel,
        stat_fn: StatisticFn,
        params,
        observations: jax.Array,      # [W, m] buffered window
        *,
        key: jax.Array,
        n_particles: int,
        statistic_dim: int,
        smoother: str = "poyiadjis_N",
        step_weights: jax.Array | None = None,   # [W]: w_t in-window, 0 outside
        in_window: jax.Array | None = None,      # [W] floats {0., 1.}
        prior_mean=0.0,
        prior_var=1.0,
        resampler: str = "multinomial",
        resample_mode: str = "gather",
        lambduh: float = 0.95,
        n_tilde: int = 2,
        logsumexp_mode: bool = False,
        elementwise: bool = False,
        window_length: int | None = None,
        save_all: bool = False,
        ess_threshold: float | None = None,
        bw_chunk: int | None = None,
        fixed_lag: int | None = None,
        step_valid: jax.Array | None = None,   # [W] {0., 1.}: padded tails
) -> PFOutput:
    """Run ``W`` steps of a buffered particle smoother over one window.

    ``resample_mode``: ``'gather'`` draws ancestor indices with the
    `resampling` schemes and gathers each carried array; ``'auto'``
    resamples the joint (particles, statistics) matrix in one gather
    (`resampling.resample_apply`).

    ``step_weights`` carries both the buffering (zero outside ``[t1, tL)``)
    and the subsequence-unbiasedness weights; ``in_window`` gates the
    log-likelihood accumulation (`buffered_smoother.py:96-126`).

    ``fixed_lag`` (elementwise smoothers only) returns fixed-lag smoothed
    elementwise statistics E[h_t | y_{<= t+lag}] in ``mean_statistic``:
    slot ``t`` of the running elementwise statistic is snapshotted (weight-
    averaged) at step ``t + lag``; slots within ``lag`` of the window end
    use the final (fully smoothed) statistic, which conditions on the same
    observations.  This exceeds the reference, whose `pf_latent_var_distr`
    raises for ``lag not in (None, 0)`` (`svm/helper.py:253-258`).
    """
    W = observations.shape[0]
    dtype = observations.dtype
    if step_weights is None:
        step_weights = jnp.ones((W,), dtype)
    if in_window is None:
        in_window = (step_weights > 0).astype(dtype)

    H = statistic_dim * (window_length if elementwise else 1) if elementwise \
        else statistic_dim
    if elementwise:
        if window_length is None:
            raise ValueError("elementwise mode needs static window_length")
        # t1 is inferred from the first in-window index.
        t1 = jnp.argmax(in_window > 0)
        stat_fn = elementwise_statistic_fn(stat_fn, t1, window_length,
                                           statistic_dim)
        H = statistic_dim * window_length
    if resample_mode not in ("gather", "auto"):
        raise ValueError(
            f"run_buffered_pf resample_mode must be 'gather' or 'auto', got "
            f"'{resample_mode}' (the fused window kernel runs through "
            f"inference.sgmcmc.make_pf_score_fn)")

    step = make_smoother_step(smoother, kernel, stat_fn,
                              resampler_name=resampler, lambduh=lambduh,
                              n_tilde=n_tilde, logsumexp_mode=logsumexp_mode,
                              resample_mode=resample_mode,
                              ess_threshold=ess_threshold,
                              bw_chunk=bw_chunk)

    key_init, key_steps = jax.random.split(key)
    x0 = kernel.sample_x0(params, key_init, n_particles, prior_mean, prior_var)
    x0 = x0.astype(dtype)
    log_w0 = jnp.zeros((n_particles,), dtype)
    stats0 = jnp.zeros((H,), dtype) if smoother == "filter" else \
        jnp.zeros((n_particles, H), dtype)
    carry0 = PFCarry(x0, log_w0, stats0, jnp.zeros((), dtype))

    step_keys = jax.random.split(key_steps, W)
    xs = PFStepInput(
        key=step_keys,
        y=observations,
        weight=step_weights,
        in_window=in_window,
        t=jnp.arange(W, dtype=jnp.int32),
        valid=step_valid,
    )

    if fixed_lag is not None:
        if not elementwise or smoother == "filter":
            raise ValueError("fixed_lag requires an elementwise smoother")
        if save_all:
            raise ValueError("fixed_lag and save_all are exclusive")

    def body(carry, inp):
        new_carry = step(params, carry, inp)
        if inp.valid is not None:
            # padded-tail gate: freeze the whole carry so fake observations
            # beyond the true sequence end cannot perturb the filter state
            # or the statistic ancestry
            new_carry = PFCarry(*[jnp.where(inp.valid > 0, n, o)
                                  for n, o in zip(new_carry, carry)])
        if fixed_lag is not None:
            # snapshot slot (t - lag) over the *current* particle cloud:
            # the fixed-lag smoothed statistic E[h_{t-lag} | y_{<= t}].
            slot = jnp.maximum(inp.t - fixed_lag, 0) * statistic_dim
            sl = jax.lax.dynamic_slice(
                new_carry.statistics, (jnp.zeros((), slot.dtype), slot),
                (new_carry.statistics.shape[0], statistic_dim))    # [N, d]
            probs = normalize_log_weights(new_carry.log_weights)
            return new_carry, probs @ sl
        return new_carry, (new_carry if save_all else None)

    carry, saved = jax.lax.scan(body, carry0, xs)

    mean_stat = average_statistic(carry.statistics, carry.log_weights)
    if fixed_lag is not None:
        lag = min(fixed_lag, W)
        final = mean_stat.reshape(W if window_length is None
                                  else window_length, statistic_dim)
        # lagged[t] was emitted at step t + lag; the last `lag` slots keep
        # the final smoothed value (same conditioning set).
        lagged = jnp.concatenate([saved[lag:], final[W - lag:W]], axis=0)
        if final.shape[0] > W:      # zero-padded tail slots, if any
            lagged = jnp.concatenate([lagged, final[W:]], axis=0)
        mean_stat = lagged.reshape(-1)

    out = PFOutput(
        statistics=carry.statistics,
        log_weights=carry.log_weights,
        particles=carry.particles,
        loglikelihood=carry.loglik,
        mean_statistic=mean_stat,
    )
    if save_all:
        return out, saved
    return out


def window_weights(t1, tL, subseq_weights: jax.Array, window: int,
                   dtype=jnp.float32):
    """Expand subsequence weights [S] into full-window step weights [W].

    Steps in ``[t1, tL)`` get ``subseq_weights[t - t1]``; all others get 0.
    Works with traced ``t1``/``tL`` (the window layout is data-dependent).
    """
    t = jnp.arange(window)
    rel = t - t1
    S = subseq_weights.shape[0]
    valid = (rel >= 0) & (t < tL)
    w = jnp.take(subseq_weights, jnp.clip(rel, 0, S - 1))
    return jnp.where(valid, w, 0.0).astype(dtype), valid.astype(dtype)
