"""SG-MCMC steppers and noisy-gradient assembly, as pure jittable functions.

Functional rewrite of the sampler core
(`/root/reference/sgmcmc_ssm/sgmcmc_sampler.py:259-657`): the buffered
stochastic gradient (`noisy_gradient` `:427`), SGD/ADAGRAD optimizer steps
(`:467-527`), and the SGLD / SGLD-CV / SGRLD samplers (`:549-640`) operate on
parameter *pytrees*; every step compiles into the training scan and vmaps
over chains.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import ParticleKernel, StatisticFn
from ..ops.buffered import run_buffered_pf, window_weights
from ..ops.dispatch import check_resample_mode, pf_path
from ..ops.pallas.fused_pf import fused_pf_score, supports_particles
from ..ops.subsequence import (sample_buffered_window, sample_subsequence,
                               window_length)

Params = Any
GradFn = Callable[..., tuple[Params, jax.Array]]


# --------------------------------------------------------------------------
# Pytree helpers
# --------------------------------------------------------------------------

def tree_random_normal(key, tree, scale=1.0):
    """Gaussian pytree with leaf-wise std sqrt(scale)
    (`_get_sgmcmc_noise`, `sgmcmc_sampler.py:529-547`)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(key, len(leaves))
    std = jnp.sqrt(scale)
    noise = [std * jax.random.normal(k, x.shape, x.dtype)
             for k, x in zip(keys, leaves)]
    return jax.tree_util.tree_unflatten(treedef, noise)


def tree_axpy(a, x, y):
    """a * x + y over pytrees."""
    return jax.tree_util.tree_map(lambda xi, yi: a * xi + yi, x, y)


def tree_add(*trees):
    return jax.tree_util.tree_map(lambda *xs: sum(xs), *trees)


def tree_scale(a, x):
    return jax.tree_util.tree_map(lambda xi: a * xi, x)


# --------------------------------------------------------------------------
# Noisy gradient from the buffered particle filter
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PFScoreConfig:
    """Static configuration of the buffered PF score estimator."""
    n_particles: int = 1000
    subsequence_length: int = -1        # -1: full sequence
    buffer_length: int = 0
    minibatch_size: int = 1
    smoother: str = "poyiadjis_N"       # nemeth|poyiadjis_N|poyiadjis_N2|paris|filter
    resampler: str = "multinomial"
    resample_mode: str = "gather"       # gather|fused|auto (ops/dispatch.py)
    lambduh: float = 0.95
    n_tilde: int = 2
    partition_style: str = "uniform"
    # ESS-adaptive resampling: resample only when ESS < ess_threshold * N.
    # None (the parity default) resamples every step, as the reference does.
    ess_threshold: float | None = None
    # Row-chunk size for the dense [N, N] backward-weight smoothers
    # (poyiadjis_N2, paris, paris_ar fallback): streams the contraction in
    # blocks of this many rows — O(bw_chunk * N) live memory instead of
    # O(N^2) for large N (e.g. the reference's N=1e4-1e6 ground-truth /
    # KSD configs).  None auto-selects (dense up to N=8192, ~4096-row
    # blocks above); chunking changes only GEMM tiling.
    bw_chunk: int | None = None

    def __post_init__(self):
        check_resample_mode(self.resample_mode)


def _fused_eligible(config: PFScoreConfig, fused_model) -> bool:
    """The fused window kernel handles the systematic-resampled
    Nemeth/Poyiadjis-O(N) smoothers for models providing a FusedModel."""
    return (fused_model is not None
            and config.smoother in ("poyiadjis_N", "nemeth")
            and config.resampler == "systematic"
            and supports_particles(config.n_particles))


def make_pf_score_fn(kernel: ParticleKernel, stat_fn: StatisticFn,
                     statistic_dim: int, unpack: Callable[[jax.Array], Params],
                     config: PFScoreConfig, T: int,
                     prior_mean_var_fn: Callable[[Params], tuple] | None = None,
                     fused_model=None):
    """Build score_fn(key, params, observations[T, m]) -> (grad_tree, loglik).

    One minibatch element = one buffered subsequence window run through the
    particle smoother (`_single_noisy_grad_loglikelihood` kind='pf',
    `sgmcmc_sampler.py:364-384`); the minibatch axis is vmapped.  When the
    model supplies a ``fused_model`` bundle and the config qualifies, the
    whole window runs in one Pallas kernel (`ops/pallas/fused_pf.py`;
    `ops/dispatch.pf_path` decides).
    """
    S = config.subsequence_length
    full = (S == -1) or (S >= T)
    W = T if full else window_length(S, config.buffer_length, T)
    path = pf_path(config.resample_mode, _fused_eligible(config, fused_model))
    fused_lambduh = 1.0 if config.smoother == "poyiadjis_N" \
        else config.lambduh

    def one_window(key, params, observations):
        dtype = observations.dtype
        key_win, key_pf = jax.random.split(key)
        if full:
            window = observations
            step_w = jnp.ones((T,), dtype)
            in_win = jnp.ones((T,), dtype)
        else:
            win = sample_buffered_window(key_win, S, config.buffer_length, T,
                                         config.partition_style, dtype)
            window = jax.lax.dynamic_slice_in_dim(
                observations, win.window_start, W, axis=0)
            step_w, in_win = window_weights(win.t1, win.tL, win.weights, W,
                                            dtype)
        if prior_mean_var_fn is None:
            prior_mean, prior_var = (jnp.zeros((), dtype),
                                     jnp.asarray(10.0, dtype))
        else:
            prior_mean, prior_var = prior_mean_var_fn(params)
        if path.fused:
            return fused_pf_score(
                fused_model, key_pf, params, window, step_w,
                config.n_particles, prior_mean, prior_var,
                lambduh=fused_lambduh, interpret=path.interpret,
                ess_threshold=config.ess_threshold)
        out = run_buffered_pf(
            kernel, stat_fn, params, window,
            key=key_pf, n_particles=config.n_particles,
            statistic_dim=statistic_dim, smoother=config.smoother,
            step_weights=step_w, in_window=in_win,
            prior_mean=prior_mean, prior_var=prior_var,
            resampler=config.resampler, resample_mode=config.resample_mode,
            lambduh=config.lambduh, n_tilde=config.n_tilde,
            ess_threshold=config.ess_threshold, bw_chunk=config.bw_chunk)
        return out.mean_statistic, out.loglikelihood

    def score_fn(key, params, observations):
        keys = jax.random.split(key, config.minibatch_size)
        stats, logliks = jax.vmap(
            lambda k: one_window(k, params, observations))(keys)
        mean_stat = jnp.mean(stats, axis=0)
        return unpack(mean_stat), jnp.mean(logliks)

    return score_fn


def make_seq_pf_score_fn(kernel: ParticleKernel, stat_fn: StatisticFn,
                         statistic_dim: int,
                         unpack: Callable[[jax.Array], Params],
                         config: PFScoreConfig, lengths,
                         num_sequences: int = -1,
                         prior_mean_var_fn=None,
                         fused_model=None):
    """Multi-sequence buffered PF score (`SeqSGMCMCSampler`,
    `sgmcmc_sampler.py:1157-1423`).

    Sequences are packed [n_seq, T_max, m] with true ``lengths``; each
    gradient draws ``num_sequences`` sequences without replacement (-1 =
    all), runs one buffered subsequence per chosen sequence (per-sequence
    T_i drives the unbiasedness weights), sums, and rescales by
    T_total / sum(T_chosen).
    """
    lengths = jnp.asarray(lengths, jnp.int32)
    n_seq = int(lengths.shape[0])
    T_total = float(jnp.sum(lengths))
    S = config.subsequence_length
    full = S == -1
    min_len = int(jnp.min(lengths))
    # buffer_length == -1: buffer to the whole sequence (full padded
    # window; steps beyond T_i carry zero weight and only feed the filter)
    full_buffers = config.buffer_length == -1
    if full or full_buffers:
        W = None  # set per call from the packed T_max
        if not full and S > min_len:
            raise ValueError(f"subsequence {S} exceeds shortest sequence "
                             f"{min_len}")
    else:
        W = S + 2 * config.buffer_length
        if W > min_len:
            raise ValueError(f"window {W} exceeds shortest sequence "
                             f"{min_len}")
    k_chosen = n_seq if num_sequences == -1 else num_sequences
    path = pf_path(config.resample_mode, _fused_eligible(config, fused_model))
    fused_lambduh = 1.0 if config.smoother == "poyiadjis_N" \
        else config.lambduh

    def one_sequence(key, params, obs_i, T_i):
        dtype = obs_i.dtype
        key_start, key_pf = jax.random.split(key)
        step_valid = None
        if full:
            # full-sequence (LD) estimator: the whole padded sequence is
            # the window; steps past T_i carry zero weight and are
            # validity-gated so padding cannot perturb the filter.
            W_i = obs_i.shape[0]
            window = obs_i
            t = jnp.arange(W_i)
            step_w = (t < T_i).astype(dtype)
            in_win = step_w
            step_valid = step_w
        else:
            u = jax.random.uniform(key_start, ())
            start = jnp.floor(u * (T_i - S + 1)).astype(jnp.int32)
            t = start + jnp.arange(S)
            n_cov = jnp.minimum(
                jnp.minimum(t + 1, S),
                jnp.minimum(T_i - S + 1, T_i - t)).astype(dtype)
            weights = (T_i - S + 1).astype(dtype) / n_cov
            if full_buffers:
                # whole padded sequence as the window; only [start,
                # start+S) carries weight, real rows feed the filter,
                # padded tails are validity-gated
                W_i = obs_i.shape[0]
                window = obs_i
                t1 = start
                step_valid = (jnp.arange(W_i) < T_i).astype(dtype)
            else:
                W_i = W
                window_start = jnp.clip(start - config.buffer_length, 0,
                                        T_i - W_i)
                t1 = start - window_start
                window = jax.lax.dynamic_slice_in_dim(obs_i, window_start,
                                                      W_i, axis=0)
            step_w, in_win = window_weights(t1, t1 + S, weights, W_i, dtype)
        if prior_mean_var_fn is None:
            pm, pv = jnp.zeros((), dtype), jnp.asarray(10.0, dtype)
        else:
            pm, pv = prior_mean_var_fn(params)
        if path.fused:
            return fused_pf_score(
                fused_model, key_pf, params, window, step_w,
                config.n_particles, pm, pv, lambduh=fused_lambduh,
                interpret=path.interpret,
                ess_threshold=config.ess_threshold, step_valid=step_valid)
        out = run_buffered_pf(
            kernel, stat_fn, params, window, key=key_pf,
            n_particles=config.n_particles, statistic_dim=statistic_dim,
            smoother=config.smoother, step_weights=step_w, in_window=in_win,
            prior_mean=pm, prior_var=pv, resampler=config.resampler,
            resample_mode=config.resample_mode, lambduh=config.lambduh,
            n_tilde=config.n_tilde, ess_threshold=config.ess_threshold,
            bw_chunk=config.bw_chunk, step_valid=step_valid)
        return out.mean_statistic, out.loglikelihood

    def score_fn(key, params, observations):
        key_seq, key_pf = jax.random.split(key)
        if num_sequences == -1:
            idx = jnp.arange(n_seq)
        else:
            idx = jax.random.permutation(key_seq, n_seq)[:k_chosen]
        keys = jax.random.split(key_pf, k_chosen)
        stats, logliks = jax.vmap(
            lambda k, i: one_sequence(k, params, observations[i],
                                      lengths[i]))(keys, idx)
        scale = T_total / jnp.sum(lengths[idx]).astype(stats.dtype)
        stat = jnp.sum(stats, axis=0) * scale
        return unpack(stat), jnp.sum(logliks) * scale

    return score_fn


def make_seq_marginal_score_fn(windowed_gradient_fn, config: PFScoreConfig,
                               lengths, num_sequences: int = -1):
    """Multi-sequence buffered *exact-message* score (kind='marginal'
    under `SeqSGMCMCSampler`, `sgmcmc_sampler.py:1259-1283`).

    Sequences are packed [n_seq, T_max, ...] with true ``lengths``.  With a
    finite subsequence length each chosen sequence contributes one
    buffered [B | S | B] window (buffers clipped at that sequence's edges
    via the validity mask, unbiasedness weights from that sequence's own
    T_i); with ``subsequence_length == -1`` every chosen sequence's *full*
    exact gradient runs on the fixed-shape padded array with a validity
    mask (one vmapped program — compile time and program size are
    independent of n_seq, unlike the reference's per-sequence Python
    loop).  Either way the sum is rescaled by T_total / sum(T_chosen).

    ``windowed_gradient_fn(params, window, valid, weights, B, S)`` is the
    model's windowed marginal gradient (note: B and S passed explicitly
    here because the full path needs per-sequence S).
    """
    lengths_np = np.asarray(lengths)
    lengths = jnp.asarray(lengths, jnp.int32)
    n_seq = int(lengths_np.shape[0])
    T_total = float(lengths_np.sum())
    S = config.subsequence_length
    B = (int(lengths_np.max()) if config.buffer_length == -1
         else max(config.buffer_length, 0))
    full = S == -1
    k_chosen = n_seq if num_sequences == -1 else num_sequences
    if not full:
        if S > int(lengths_np.min()):
            raise ValueError(f"subsequence {S} exceeds shortest sequence "
                             f"{int(lengths_np.min())}")
        W = S + 2 * B

    def one_sequence(key, params, obs_i, T_i):
        dtype = obs_i.dtype
        key_start, _ = jax.random.split(key)
        u = jax.random.uniform(key_start, ())
        start = jnp.floor(u * (T_i - S + 1)).astype(jnp.int32)
        t = start + jnp.arange(S)
        n_cov = jnp.minimum(
            jnp.minimum(t + 1, S),
            jnp.minimum(T_i - S + 1, T_i - t)).astype(dtype)
        weights = (T_i - S + 1).astype(dtype) / n_cov
        idx = start - B + jnp.arange(W)
        valid = ((idx >= 0) & (idx < T_i)).astype(dtype)
        window = jnp.take(obs_i, jnp.clip(idx, 0, obs_i.shape[0] - 1),
                          axis=0)
        return windowed_gradient_fn(params, window, valid, weights, B, S)

    def one_full(params, obs_i, T_i):
        dtype = obs_i.dtype
        T_max = obs_i.shape[0]
        vld = (jnp.arange(T_max) < T_i).astype(dtype)
        return windowed_gradient_fn(params, obs_i, vld, vld, 0, T_max)

    def score_fn(key, params, observations):
        key_seq, key_g = jax.random.split(key)
        dtype = observations.dtype
        if num_sequences == -1:
            idx = jnp.arange(n_seq)
        else:
            idx = jax.random.permutation(key_seq, n_seq)[:k_chosen]
        if full:
            grads, logliks = jax.vmap(
                lambda i: one_full(params, observations[i],
                                   lengths[i]))(idx)
        else:
            keys = jax.random.split(key_g, k_chosen)
            grads, logliks = jax.vmap(
                lambda k, i: one_sequence(k, params, observations[i],
                                          lengths[i]))(keys, idx)
        grad = jax.tree_util.tree_map(lambda g: jnp.sum(g, axis=0), grads)
        loglik = jnp.sum(logliks)
        scale = T_total / jnp.sum(lengths[idx]).astype(dtype)
        return jax.tree_util.tree_map(lambda g: g * scale, grad), \
            loglik * scale

    return score_fn


def make_marginal_score_fn(windowed_gradient_fn, config: PFScoreConfig,
                           T: int, pass_key: bool = False):
    """Buffered *exact-message* score estimator (kind='marginal').

    ``windowed_gradient_fn(params, window, valid, weights) ->
    (grad_tree, loglik)`` computes boundary messages over the [B | S | B]
    window's buffers and the weighted gradient over the center — see
    `lgssm.windowed_marginal_gradient`.  The window is rolled so the
    subsequence always occupies the static center slice; edge clipping is
    expressed through the validity mask (matching the reference's
    truncated buffers, `sgmcmc_sampler.py:259-288`).
    """
    S = config.subsequence_length
    full = (S == -1) or (S >= T)
    B = 0 if full else (T if config.buffer_length == -1
                        else max(config.buffer_length, 0))
    S_eff = T if full else S
    W = S_eff + 2 * B

    def one_window(key, params, observations):
        dtype = observations.dtype
        key_win, key_fn = jax.random.split(key)
        if full:
            valid = jnp.ones((T,), dtype)
            weights = jnp.ones((T,), dtype)
            window = observations
        else:
            start, weights = sample_subsequence(key_win, S, T,
                                                config.partition_style, dtype)
            idx = start - B + jnp.arange(W)
            valid = ((idx >= 0) & (idx < T)).astype(dtype)
            window = jnp.take(observations, jnp.clip(idx, 0, T - 1), axis=0)
        if pass_key:
            return windowed_gradient_fn(key_fn, params, window, valid,
                                        weights)
        return windowed_gradient_fn(params, window, valid, weights)

    def score_fn(key, params, observations):
        keys = jax.random.split(key, config.minibatch_size)
        grads, logliks = jax.vmap(
            lambda k: one_window(k, params, observations))(keys)
        grad = jax.tree_util.tree_map(lambda g: jnp.mean(g, axis=0), grads)
        return grad, jnp.mean(logliks)

    return score_fn


def make_noisy_grad_fn(score_fn, grad_logprior_fn, T: int,
                       is_scaled: bool = True,
                       preconditioner=None):
    """grad = (grad loglike estimate + grad logprior) / T
    (`noisy_gradient`, `sgmcmc_sampler.py:427-464`)."""
    def noisy_grad(key, params, observations):
        grad_ll, loglik = score_fn(key, params, observations)
        grad = tree_add(grad_ll, grad_logprior_fn(params))
        scale = (1.0 / T) if is_scaled else 1.0
        if preconditioner is None:
            grad = tree_scale(scale, grad)
        else:
            grad = tree_scale(scale, preconditioner.precondition(params, grad))
        return grad, loglik

    return noisy_grad


# --------------------------------------------------------------------------
# Preconditioner protocol (SGRLD), `base_parameters.py:260-322`
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Preconditioner:
    """Riemannian preconditioner D(theta) as three pure functions."""
    precondition: Callable[[Params, Params], Params]          # D * grad
    precondition_noise: Callable[[Params, jax.Array], Params]  # sqrt(D) * xi
    correction_term: Callable[[Params], Params]                # Gamma(theta)

    def __hash__(self):
        return hash((self.precondition, self.precondition_noise,
                     self.correction_term))


# --------------------------------------------------------------------------
# Steps (`sgmcmc_sampler.py:467-640`)
# --------------------------------------------------------------------------

def sgd_step(key, params, observations, noisy_grad_fn, epsilon):
    grad, loglik = noisy_grad_fn(key, params, observations)
    return tree_axpy(epsilon, grad, params), loglik


def sgld_step(key, params, observations, noisy_grad_fn, epsilon, T,
              is_scaled: bool = True):
    """theta += eps * grad + sqrt(2 eps) * N(0, 1/T)  (`:549-567`)."""
    key_grad, key_noise = jax.random.split(key)
    grad, loglik = noisy_grad_fn(key_grad, params, observations)
    scale = (1.0 / T) if is_scaled else 1.0
    noise = tree_random_normal(key_noise, params, scale)
    new = jax.tree_util.tree_map(
        lambda p, g, n: p + epsilon * g + jnp.sqrt(2.0 * epsilon) * n,
        params, grad, noise)
    return new, loglik


def sgrld_step(key, params, observations, noisy_grad_fn, preconditioner,
               epsilon, T, is_scaled: bool = True):
    """Riemannian SGLD with preconditioner and correction (`:613-640`).

    ``noisy_grad_fn`` must already apply ``preconditioner.precondition``.
    """
    key_grad, key_noise = jax.random.split(key)
    grad, loglik = noisy_grad_fn(key_grad, params, observations)
    scale = (1.0 / T) if is_scaled else 1.0
    noise = preconditioner.precondition_noise(params, key_noise)
    noise = tree_scale(jnp.sqrt(scale), noise)
    correction = tree_scale(scale, preconditioner.correction_term(params))
    new = jax.tree_util.tree_map(
        lambda p, g, c, n: p + epsilon * (g + c) + jnp.sqrt(2.0 * epsilon) * n,
        params, grad, correction, noise)
    return new, loglik


class AdagradState(NamedTuple):
    G: Params     # accumulated squared gradients
    t: jax.Array


ADAGRAD_NUGGET = 1e-9  # NOISE_NUGGET, `sgmcmc_sampler.py:10`


def adagrad_init(params) -> AdagradState:
    return AdagradState(
        G=jax.tree_util.tree_map(jnp.zeros_like, params),
        t=jnp.zeros((), jnp.int32))


def adagrad_step(key, params, state: AdagradState, observations,
                 noisy_grad_fn, epsilon):
    """ADAGRAD optimizer step (`sgmcmc_sampler.py:504-527`)."""
    grad, loglik = noisy_grad_fn(key, params, observations)
    G = jax.tree_util.tree_map(lambda Gi, g: Gi + g * g, state.G, grad)
    new = jax.tree_util.tree_map(
        lambda p, g, Gi: p + epsilon * g / jnp.sqrt(Gi + ADAGRAD_NUGGET),
        params, grad, G)
    return new, AdagradState(G=G, t=state.t + 1), loglik


def sgld_cv_step(key, params, observations, noisy_grad_fn,
                 centering_params, centering_grad, epsilon, T,
                 is_scaled: bool = True):
    """SGLD with control variates (`sgmcmc_sampler.py:569-611`).

    Uses the same subsequence draw for the current and centering gradients
    by reusing the PRNG key, the functional analogue of the reference's
    shared ``buffer_dicts``.
    """
    key_grad, key_noise = jax.random.split(key)
    grad_cur, loglik = noisy_grad_fn(key_grad, params, observations)
    grad_cen, _ = noisy_grad_fn(key_grad, centering_params, observations)
    delta = jax.tree_util.tree_map(lambda full, c, cc: full + c - cc,
                                   centering_grad, grad_cur, grad_cen)
    scale = (1.0 / T) if is_scaled else 1.0
    noise = tree_random_normal(key_noise, params, scale)
    new = jax.tree_util.tree_map(
        lambda p, g, n: p + epsilon * g + jnp.sqrt(2.0 * epsilon) * n,
        params, delta, noise)
    return new, loglik


# --------------------------------------------------------------------------
# Fit loop (`fit`, `sgmcmc_sampler.py:659-722`) as one scan
# --------------------------------------------------------------------------

def fit(key, params, observations, step_fn, num_iters: int,
        project_fn=None, steps_per_iter: int = 1, output_all: bool = True):
    """Run ``num_iters`` iterations of ``step_fn`` under one lax.scan.

    step_fn(key, params, observations) -> (params, aux).  Each iteration runs
    ``steps_per_iter`` steps (the reference's `steps_per_iteration`) and
    optionally projects.  Returns (final_params, stacked trace of params
    after each iteration, stacked aux).
    """
    def one_iter(params, key):
        def one_step(p, k):
            p, aux = step_fn(k, p, observations)
            if project_fn is not None:
                p = project_fn(p)
            return p, aux

        step_keys = jax.random.split(key, steps_per_iter)
        params, aux = jax.lax.scan(one_step, params, step_keys)
        out = (params, aux[-1]) if output_all else aux[-1]
        return params, out

    iter_keys = jax.random.split(key, num_iters)
    params, outputs = jax.lax.scan(one_iter, params, iter_keys)
    if output_all:
        trace, aux = outputs
        return params, trace, aux
    return params, None, outputs


def fit_with_state(key, params, state, observations, step_fn,
                   num_iters: int, project_fn=None, steps_per_iter: int = 1,
                   output_all: bool = True):
    """`fit` for steppers that carry optimizer state (ADAGRAD moments,
    `sgmcmc_sampler.py:504-527`): step_fn(key, params, state, observations)
    -> (params, state, aux).  Returns (params, state, trace, aux)."""
    def one_iter(carry, key):
        def one_step(c, k):
            p, st = c
            p, st, aux = step_fn(k, p, st, observations)
            if project_fn is not None:
                p = project_fn(p)
            return (p, st), aux

        step_keys = jax.random.split(key, steps_per_iter)
        (params, state), aux = jax.lax.scan(one_step, carry, step_keys)
        out = (params, aux[-1]) if output_all else aux[-1]
        return (params, state), out

    iter_keys = jax.random.split(key, num_iters)
    (params, state), outputs = jax.lax.scan(one_iter, (params, state),
                                            iter_keys)
    if output_all:
        trace, aux = outputs
        return params, state, trace, aux
    return params, state, None, outputs
