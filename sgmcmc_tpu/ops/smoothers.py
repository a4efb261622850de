"""Particle filter / smoother step functions as `lax.scan` bodies.

Vectorized redesigns of the five smoother steps in
`/root/reference/sgmcmc_ssm/particle_filters/pf.py`:

* ``filter``        — `pf_filter` (`pf.py:40-82`): filtering accumulator.
* ``nemeth``        — `nemeth_smoother` (`pf.py:138-181`): O(N) shrinkage.
* ``poyiadjis_n``   — Nemeth with lambda=1 (`buffered_smoother.py:175-180`).
* ``poyiadjis_n2``  — `poyiadjis_smoother` (`pf.py:84-136`): the O(N^2)
  backward-weight contraction, expressed as a dense matmul
  ``new_stats = BW @ stats + einsum(BW, H_pairs)``.
* ``paris``         — `paris_smoother` (`pf.py:183-258`): backward sampling
  from the exact N x N backward weights via per-row categorical draws
  (statistically identical to the reference's accept-reject construction,
  whose only purpose is CPU-side O(N*K) cost; on an accelerator the dense row weights
  are a single fused matmul/softmax).

Each step maps ``(particles, log_weights, statistics) -> same`` plus a running
log-likelihood estimate, with per-step additive-statistic weighting
``w_t * in_window`` replacing the reference's function-swapping
(`buffered_smoother.py:96-112`).

All functions are pure; PRNG keys are threaded explicitly.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.base import ParticleKernel, StatisticFn
from .resampling import get_resampler, normalize_log_weights, resample_apply


class PFCarry(NamedTuple):
    particles: jax.Array       # [N, D]
    log_weights: jax.Array     # [N]
    statistics: jax.Array      # [N, H] (smoothers) or [H] (filter)
    loglik: jax.Array          # scalar running loglikelihood estimate


class PFStepInput(NamedTuple):
    key: jax.Array             # per-step PRNG key
    y: jax.Array               # [m] observation y_t
    weight: jax.Array          # scalar: subsequence weight w_t (0 off-window)
    in_window: jax.Array       # scalar {0., 1.}: t in [t1, tL)
    t: jax.Array               # int32 absolute step index within the window
    # scalar {0., 1.} validity gate for zero-padded sequence tails: invalid
    # steps freeze the whole carry (run_buffered_pf applies the gate; None
    # = all valid).  Distinct from in_window: buffer steps are valid but
    # out-of-window.
    valid: jax.Array | None = None


def _ess_gate(log_weights: jax.Array, ess_threshold: float | None):
    """(do_resample, carried_log_weights) for ESS-adaptive resampling.

    ``carried_log_weights`` are the normalized-to-uniform log weights
    (``logsumexp == log N``) that survive a *skipped* resampling step; with
    ``ess_threshold=None`` (parity default: resample every step, as the
    reference does at `pf.py:24-27`) the gate is statically always-on.
    """
    if ess_threshold is None:
        return None, None
    n = log_weights.shape[0]
    lwn = log_weights - jax.scipy.special.logsumexp(log_weights)
    ess = 1.0 / jnp.sum(jnp.exp(2.0 * lwn))
    do_res = ess < ess_threshold * n
    carried = lwn + jnp.log(jnp.asarray(float(n), log_weights.dtype))
    return do_res, jnp.where(jnp.isfinite(carried), carried, 0.0)


def _propagate(kernel: ParticleKernel, resampler, params, key, particles,
               log_weights, y, ess_threshold: float | None = None):
    """Bootstrap PF step: resample -> propose -> reweight (`pf.py:7-38`).

    With ``ess_threshold`` set, steps whose effective sample size exceeds
    ``ess_threshold * N`` skip resampling: ancestors become the identity and
    the normalized previous weights carry into the new importance weights
    (the standard adaptive-resampling estimator; the per-step likelihood
    increment ``logsumexp(new_log_w) - log N`` stays consistent).
    """
    key_res, key_prop = jax.random.split(key)
    ancestors = resampler(key_res, log_weights)
    do_res, carried = _ess_gate(log_weights, ess_threshold)
    if do_res is not None:
        iota = jnp.arange(particles.shape[0], dtype=ancestors.dtype)
        ancestors = jnp.where(do_res, ancestors, iota)
    parents = jnp.take(particles, ancestors, axis=0)
    new_particles = kernel.propose(params, key_prop, parents, y)
    new_log_weights = kernel.reweight(params, parents, new_particles, y)
    if do_res is not None:
        new_log_weights = new_log_weights + jnp.where(do_res, 0.0, carried)
    return parents, new_particles, new_log_weights, ancestors


def _propagate_apply(kernel: ParticleKernel, scheme: str, params,
                     key, particles, log_weights, extra_vals, y,
                     ess_threshold: float | None = None):
    """Bootstrap PF step with joint resample-apply.

    Resamples ``particles`` (and optionally per-particle ``extra_vals``,
    e.g. running smoother statistics) in one gather of the joint value
    matrix — see `resampling.resample_apply`.  Returns (parents,
    new_particles, new_log_weights, resampled_extra_vals).
    ``ess_threshold`` selects the un-resampled values instead (the gather
    still runs: the gate is a statistical option, not a speed one).
    """
    key_res, key_prop = jax.random.split(key)
    if extra_vals is None:
        V = particles
    else:
        V = jnp.concatenate([particles, extra_vals], axis=-1)
    Vr = resample_apply(key_res, log_weights, V, scheme)
    do_res, carried = _ess_gate(log_weights, ess_threshold)
    if do_res is not None:
        Vr = jnp.where(do_res, Vr, V)
    D = particles.shape[-1]
    parents = Vr[:, :D]
    extras = None if extra_vals is None else Vr[:, D:]
    new_particles = kernel.propose(params, key_prop, parents, y)
    new_log_weights = kernel.reweight(params, parents, new_particles, y)
    if do_res is not None:
        new_log_weights = new_log_weights + jnp.where(do_res, 0.0, carried)
    return parents, new_particles, new_log_weights, extras


def _loglik_increment(new_log_weights):
    """log(mean(exp(log_w))) — per-step marginal-likelihood increment
    (`buffered_smoother.py:124-126`), computed stably via logsumexp."""
    n = new_log_weights.shape[-1]
    return jax.scipy.special.logsumexp(new_log_weights, axis=-1) - jnp.log(
        jnp.asarray(float(n), new_log_weights.dtype))


def make_filter_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                     resampler_name: str = "multinomial",
                     logsumexp_mode: bool = False,
                     resample_mode: str = "gather",
                     ess_threshold: float | None = None):
    """Filtering accumulator step: statistics [H] += E[h_t | y_{<=t}].

    With ``logsumexp_mode`` the accumulation is
    ``stats += log E_w[exp(h_t)]`` per statistic dimension (used by the
    predictive-loglikelihood estimator; the reference's version at
    `pf.py:73-76` collapses the statistic axis in its inner sum — we keep
    the mathematically intended per-dimension reduction).
    """
    resampler = get_resampler(resampler_name)

    def step(params, carry: PFCarry, inp: PFStepInput) -> PFCarry:
        if resample_mode == "gather":
            parents, particles, log_w, _ = _propagate(
                kernel, resampler, params, inp.key, carry.particles,
                carry.log_weights, inp.y, ess_threshold)
        else:
            parents, particles, log_w, _ = _propagate_apply(
                kernel, resampler_name, params, inp.key,
                carry.particles, carry.log_weights, None, inp.y, ess_threshold)
        h = stat_fn(params, parents, particles, inp.y, inp.t)  # [N, H]
        scale = inp.weight * inp.in_window
        probs = normalize_log_weights(log_w)                   # [N]
        if logsumexp_mode:
            h = h * scale
            m = jnp.max(h, axis=0)                             # [H]
            inc = m + jnp.log(jnp.sum(jnp.exp(h - m) * probs[:, None], axis=0))
            stats = carry.statistics + inc * inp.in_window
        else:
            stats = carry.statistics + scale * jnp.sum(h * probs[:, None], axis=0)
        loglik = carry.loglik + inp.weight * inp.in_window * _loglik_increment(log_w)
        return PFCarry(particles, log_w, stats, loglik)

    return step


def make_nemeth_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                     lambduh: float = 0.95,
                     resampler_name: str = "multinomial",
                     resample_mode: str = "gather",
                     ess_threshold: float | None = None):
    """Nemeth et al. (2015) O(N) shrinkage smoother step (`pf.py:138-181`).

    ``lambduh = 1.0`` recovers Poyiadjis O(N) (`buffered_smoother.py:175`).
    With ``resample_mode != 'gather'`` the carried statistics are resampled
    jointly with the particles through the fused one-hot matmul.
    """
    resampler = get_resampler(resampler_name)

    def step(params, carry: PFCarry, inp: PFStepInput) -> PFCarry:
        if lambduh != 1.0:
            probs = normalize_log_weights(carry.log_weights)    # [N]
            S_bar = jnp.sum(carry.statistics * probs[:, None], axis=0)
        if resample_mode == "gather":
            parents, particles, log_w, ancestors = _propagate(
                kernel, resampler, params, inp.key, carry.particles,
                carry.log_weights, inp.y, ess_threshold)
            stats_anc = jnp.take(carry.statistics, ancestors, axis=0)
        else:
            parents, particles, log_w, stats_anc = _propagate_apply(
                kernel, resampler_name, params, inp.key,
                carry.particles, carry.log_weights, carry.statistics, inp.y, ess_threshold)
        h = stat_fn(params, parents, particles, inp.y, inp.t)   # [N, H]
        scale = inp.weight * inp.in_window
        if lambduh == 1.0:
            stats = stats_anc + scale * h
        else:
            stats = (lambduh * stats_anc
                     + (1.0 - lambduh) * S_bar[None, :]
                     + scale * h)
        loglik = carry.loglik + inp.weight * inp.in_window * _loglik_increment(log_w)
        return PFCarry(particles, log_w, stats, loglik)

    return step


def _backward_log_weights(kernel: ParticleKernel, params, particles,
                          log_weights, new_particles):
    """log BW[i, j] ∝ log_w[j] + log q(x'_i | x_j)  (un-normalized).

    The reference materializes this row-by-row in Python (`pf.py:115-121`);
    here it is one vmapped batch of transition densities.
    """
    def row(x_next_i):
        x_next_b = jnp.broadcast_to(x_next_i[None, :], particles.shape)
        return log_weights + kernel.prior_log_density(params, particles, x_next_b)

    return jax.vmap(row)(new_particles)      # [N, N]


# Auto-chunk policy: above this N, bw_chunk=None streams the [N, N]
# backward weights in blocks of the largest divisor of N at most
# _BW_AUTO_CHUNK rows (chunking changes only the GEMM tiling, and keeps
# the per-step live memory at O(chunk * N) instead of O(N^2)).
_BW_AUTO_DENSE_MAX_N = 8192
_BW_AUTO_CHUNK = 4096


def _bw_row_chunks(bw_chunk: int | None, n: int):
    """Validated row-chunk count for streaming the [N, N] backward-weight
    smoothers (None auto-selects: dense up to N=8192, chunked above;
    an explicit bw_chunk >= N forces one dense materialization)."""
    if bw_chunk is None:
        if n <= _BW_AUTO_DENSE_MAX_N:
            return 1
        bw_chunk = next(d for d in range(min(_BW_AUTO_CHUNK, n), 0, -1)
                        if n % d == 0)
    if bw_chunk >= n:
        return 1
    if n % bw_chunk != 0:
        raise ValueError(
            f"bw_chunk={bw_chunk} must divide n_particles={n}")
    return n // bw_chunk


def make_poyiadjis_n2_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                           resampler_name: str = "multinomial",
                           resample_mode: str = "gather",
                           ess_threshold: float | None = None,
                           bw_chunk: int | None = None):
    """Poyiadjis et al. (2011) O(N^2) smoother step (`pf.py:84-136`).

    new_stats[i] = sum_j BW[i,j] * (stats[j] + h(x_j, x'_i)); the stats term
    is a dense [N,N]@[N,H] matmul, the pairwise-h term a
    contraction over a vmapped [N,N,H] statistic tensor.

    ``bw_chunk`` streams the contraction in row blocks of that size via
    `lax.map` — O(bw_chunk * N) live memory instead of O(N^2), the
    large-N (>= 1e4) regime the reference runs for ground-truth gradients
    (`svm_grad_compare.py:75`).  Row softmax and contraction are row-local,
    so chunked output matches the dense path up to GEMM reduction order.
    """
    resampler = get_resampler(resampler_name)

    def step(params, carry: PFCarry, inp: PFStepInput) -> PFCarry:
        if resample_mode == "gather":
            parents, particles, log_w, _ = _propagate(
                kernel, resampler, params, inp.key, carry.particles,
                carry.log_weights, inp.y, ess_threshold)
        else:
            parents, particles, log_w, _ = _propagate_apply(
                kernel, resampler_name, params, inp.key,
                carry.particles, carry.log_weights, None, inp.y, ess_threshold)
        scale = inp.weight * inp.in_window
        n = particles.shape[0]
        n_chunks = _bw_row_chunks(bw_chunk, n)

        def rows_to_stats(x_next_c):
            """[C, D] new-particle rows -> [C, H] smoothed statistics."""
            log_bw = _backward_log_weights(kernel, params, carry.particles,
                                           carry.log_weights, x_next_c)
            bw = jax.nn.softmax(log_bw, axis=-1)              # [C, N]

            # sum_j bw[i,j] * stats[j]  -> dense matmul
            smoothed = bw @ carry.statistics                  # [C, H]

            # sum_j bw[i,j] * h(x_j, x'_i)
            def h_row(x_next_i, bw_row):
                x_next_b = jnp.broadcast_to(x_next_i[None, :],
                                            carry.particles.shape)
                h = stat_fn(params, carry.particles, x_next_b,
                            inp.y, inp.t)                     # [N, H]
                return bw_row @ h                             # [H]

            h_term = jax.vmap(h_row)(x_next_c, bw)            # [C, H]
            return smoothed + scale * h_term

        if n_chunks == 1:
            stats = rows_to_stats(particles)
        else:
            chunked = particles.reshape(n_chunks, n // n_chunks,
                                        particles.shape[-1])
            stats = jax.lax.map(rows_to_stats, chunked)
            stats = stats.reshape(n, stats.shape[-1])
        loglik = carry.loglik + inp.weight * inp.in_window * _loglik_increment(log_w)
        return PFCarry(particles, log_w, stats, loglik)

    return step


def make_paris_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                    n_tilde: int = 2,
                    resampler_name: str = "multinomial",
                    resample_mode: str = "gather",
                    ess_threshold: float | None = None,
                    bw_chunk: int | None = None):
    """PaRIS (Olsson & Westerborn) step with exact backward sampling.

    Draws ``n_tilde`` backward indices per particle directly from the
    normalized backward weights (`pf.py:226-237` "naive" mode, which the
    accept-reject Algorithm 3 merely approximates in O(N*K) CPU time).

    ``bw_chunk`` streams the [N, N] backward weights in row blocks (same
    semantics as `make_poyiadjis_n2_step`; per-row draws use per-row keys,
    so the backward indices J are unchanged) — the exchange-rate KSD runs
    PaRIS at N=10,000 (`calculate_ksd.py:80`).
    """
    resampler = get_resampler(resampler_name)

    def step(params, carry: PFCarry, inp: PFStepInput) -> PFCarry:
        key_prop, key_bs = jax.random.split(inp.key)
        if resample_mode == "gather":
            parents, particles, log_w, _ = _propagate(
                kernel, resampler, params, key_prop, carry.particles,
                carry.log_weights, inp.y, ess_threshold)
        else:
            parents, particles, log_w, _ = _propagate_apply(
                kernel, resampler_name, params, key_prop,
                carry.particles, carry.log_weights, None, inp.y, ess_threshold)
        n = particles.shape[0]
        n_chunks = _bw_row_chunks(bw_chunk, n)
        bs_keys = jax.random.split(key_bs, n)
        scale = inp.weight * inp.in_window

        def rows_to_stats(args):
            """([C, D] rows, [C] keys) -> [C, H] rewired statistics."""
            x_next_c, keys_c = args
            log_bw = _backward_log_weights(
                kernel, params, carry.particles, carry.log_weights,
                x_next_c)                                         # [C, N]
            # J[i, k] ~ Categorical(BW[i, :]), k = 1..n_tilde
            J = jax.vmap(lambda k, lw: jax.random.categorical(
                k, lw, shape=(n_tilde,)))(keys_c, log_bw)         # [C, K]
            rewired_stats = jnp.take(carry.statistics, J, axis=0)  # [C, K, H]

            def h_for(x_next_i, J_i):
                xt = jnp.take(carry.particles, J_i, axis=0)       # [K, D]
                x_next_b = jnp.broadcast_to(x_next_i[None, :], xt.shape)
                return stat_fn(params, xt, x_next_b, inp.y, inp.t)  # [K, H]

            h = jax.vmap(h_for)(x_next_c, J)                      # [C, K, H]
            return jnp.mean(rewired_stats + scale * h, axis=1)    # [C, H]

        if n_chunks == 1:
            stats = rows_to_stats((particles, bs_keys))
        else:
            chunked_x = particles.reshape(n_chunks, n // n_chunks,
                                          particles.shape[-1])
            chunked_k = bs_keys.reshape((n_chunks, n // n_chunks)
                                        + bs_keys.shape[1:])
            stats = jax.lax.map(rows_to_stats, (chunked_x, chunked_k))
            stats = stats.reshape(n, stats.shape[-1])
        loglik = carry.loglik + inp.weight * inp.in_window * _loglik_increment(log_w)
        return PFCarry(particles, log_w, stats, loglik)

    return step


def accept_reject_backward_indices(key, kernel: ParticleKernel, params,
                                   particles, log_weights, new_particles,
                                   n_tilde: int,
                                   max_accept_reject: int | None = None,
                                   bw_chunk: int | None = None):
    """PaRIS Algorithm 3 backward sampling via accept-reject
    (`pf.py:260-341`), as a bounded `lax.while_loop` over masked lanes.

    Every (i, k) lane proposes ancestors I ~ Categorical(w) and accepts
    with probability q(x_I -> x'_i) / q_max; after ``max_accept_reject``
    rounds (default 100 log10(N/10), the reference's budget) any remaining
    lanes fall back to exact sampling from the dense backward weights.
    """
    import math
    N = particles.shape[0]
    if max_accept_reject is None:
        max_accept_reject = max(int(100 * math.log10(N / 10)), 8) \
            if N > 10 else 8
    log_q_max = kernel.prior_log_density_max(params)
    lanes = (N, n_tilde)

    # Proposal ancestors I ~ Categorical(w).  `jax.random.categorical` with
    # shape=lanes materializes an [N, K, N] Gumbel block per round — above
    # the threshold, draw uniforms through the (shared, precomputed) weight
    # CDF instead (identical in law, O(N*K) memory).
    from .resampling import _CATEGORICAL_MAX_N, _inverse_cdf_gather
    use_cdf = N > _CATEGORICAL_MAX_N

    def draw_ancestors(k):
        if use_cdf:
            u = jax.random.uniform(k, lanes, log_weights.dtype)
            return _inverse_cdf_gather(u, log_weights)
        return jax.random.categorical(k, log_weights,
                                      shape=lanes).astype(jnp.int32)

    def cond(state):
        i, _, accepted, _ = state
        return (i < max_accept_reject) & jnp.logical_not(jnp.all(accepted))

    def body(state):
        it, key, accepted, J = state
        key, k_prop, k_u = jax.random.split(key, 3)
        I = draw_ancestors(k_prop)
        U = jax.random.uniform(k_u, lanes, log_weights.dtype)
        x_prop = jnp.take(particles, I, axis=0)          # [N, K, D]
        x_next_b = jnp.broadcast_to(new_particles[:, None, :], x_prop.shape)
        log_q = kernel.prior_log_density(params, x_prop, x_next_b)
        accept_now = (U <= jnp.exp(log_q - log_q_max)) & ~accepted
        J = jnp.where(accept_now, I, J)
        return (it + 1, key, accepted | accept_now, J)

    key, key_loop, key_fb = jax.random.split(key, 3)
    init = (jnp.zeros((), jnp.int32), key_loop,
            jnp.zeros(lanes, bool), jnp.zeros(lanes, jnp.int32))
    _, _, accepted, J = jax.lax.while_loop(cond, body, init)

    # exact fallback for unaccepted lanes (manual sampling, `pf.py:329-339`);
    # bw_chunk streams the dense [N, N] weights in row blocks, as in
    # make_paris_step.
    n_chunks = _bw_row_chunks(bw_chunk, N)

    def exact_rows(k):
        keys = jax.random.split(k, N)

        def rows(args):
            x_next_c, keys_c = args
            log_bw = _backward_log_weights(kernel, params, particles,
                                           log_weights, x_next_c)  # [C, N]
            return jax.vmap(lambda kk, lw: jax.random.categorical(
                kk, lw, shape=(n_tilde,)))(keys_c, log_bw).astype(jnp.int32)

        if n_chunks == 1:
            return rows((new_particles, keys))
        cx = new_particles.reshape(n_chunks, N // n_chunks,
                                   new_particles.shape[-1])
        ck = keys.reshape((n_chunks, N // n_chunks) + keys.shape[1:])
        return jax.lax.map(rows, (cx, ck)).reshape(N, n_tilde)

    J_exact = jax.lax.cond(jnp.all(accepted),
                           lambda k: J, exact_rows, key_fb)
    return jnp.where(accepted, J, J_exact)


def make_paris_ar_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                       n_tilde: int = 2,
                       resampler_name: str = "multinomial",
                       resample_mode: str = "gather",
                       max_accept_reject: int | None = None,
                       ess_threshold: float | None = None,
                       bw_chunk: int | None = None):
    """PaRIS step with accept-reject backward sampling (O(N K) expected)."""
    resampler = get_resampler(resampler_name)

    def step(params, carry: PFCarry, inp: PFStepInput) -> PFCarry:
        key_prop, key_bs = jax.random.split(inp.key)
        if resample_mode == "gather":
            parents, particles, log_w, _ = _propagate(
                kernel, resampler, params, key_prop, carry.particles,
                carry.log_weights, inp.y, ess_threshold)
        else:
            parents, particles, log_w, _ = _propagate_apply(
                kernel, resampler_name, params, key_prop,
                carry.particles, carry.log_weights, None, inp.y, ess_threshold)
        J = accept_reject_backward_indices(
            key_bs, kernel, params, carry.particles, carry.log_weights,
            particles, n_tilde, max_accept_reject, bw_chunk)  # [N, K]
        scale = inp.weight * inp.in_window
        rewired_stats = jnp.take(carry.statistics, J, axis=0)

        def h_for(x_next_i, J_i):
            xt = jnp.take(carry.particles, J_i, axis=0)
            x_next_b = jnp.broadcast_to(x_next_i[None, :], xt.shape)
            return stat_fn(params, xt, x_next_b, inp.y, inp.t)

        h = jax.vmap(h_for)(particles, J)
        stats = jnp.mean(rewired_stats + scale * h, axis=1)
        loglik = carry.loglik + inp.weight * inp.in_window * _loglik_increment(log_w)
        return PFCarry(particles, log_w, stats, loglik)

    return step


def make_smoother_step(name: str, kernel: ParticleKernel, stat_fn: StatisticFn,
                       resampler_name: str = "multinomial",
                       lambduh: float = 0.95, n_tilde: int = 2,
                       logsumexp_mode: bool = False,
                       resample_mode: str = "gather",
                       ess_threshold: float | None = None,
                       bw_chunk: int | None = None):
    """Dispatch by smoother name (`buffered_smoother.py:156-199`)."""
    if name == "filter":
        return make_filter_step(kernel, stat_fn, resampler_name,
                                logsumexp_mode, resample_mode, ess_threshold)
    if name == "nemeth":
        return make_nemeth_step(kernel, stat_fn, lambduh, resampler_name,
                                resample_mode, ess_threshold)
    if name == "poyiadjis_N":
        return make_nemeth_step(kernel, stat_fn, 1.0, resampler_name,
                                resample_mode, ess_threshold)
    if name == "poyiadjis_N2":
        return make_poyiadjis_n2_step(kernel, stat_fn, resampler_name,
                                      resample_mode, ess_threshold, bw_chunk)
    if name == "paris":
        return make_paris_step(kernel, stat_fn, n_tilde, resampler_name,
                               resample_mode, ess_threshold, bw_chunk)
    if name == "paris_ar":
        return make_paris_ar_step(kernel, stat_fn, n_tilde, resampler_name,
                                  resample_mode, max_accept_reject=None,
                                  ess_threshold=ess_threshold,
                                  bw_chunk=bw_chunk)
    raise ValueError(f"Unrecognized pf = '{name}'")
