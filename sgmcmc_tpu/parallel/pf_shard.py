"""Particle-axis-sharded particle smoothers (the TP axis of SG-MCMC).

Shards a single particle filter's N particles across the ``particle`` mesh
axis.  Each device owns N/P particles; per step the (small) filter state —
log-weights, particles, per-particle statistics — is `all_gather`'d over
the device links so every device resamples its local slice from the
*global* ancestor distribution and computes its local slice of the new
state.  For the
Poyiadjis O(N^2) smoother this is the natural row decomposition of the
backward-weight matmul: each device computes its [N/P, N] block.

Statistical parity: resampling draws from the full N-particle categorical
(keys decorrelated by `axis_index`); systematic resampling uses a globally
coherent comb (device p takes stratum offsets p*N/P .. (p+1)*N/P - 1 of a
shared uniform), so the sharded filter equals the single-device filter in
distribution.

Cross-references: single-device versions in `sgmcmc_tpu/ops/smoothers.py`;
reference recursions at
`/root/reference/sgmcmc_ssm/particle_filters/pf.py:84-258`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.base import ParticleKernel, StatisticFn
from ..ops.smoothers import PFCarry, PFStepInput


def _global_categorical(key, all_log_w, n_local, axis_name):
    """Each device samples n_local global ancestor indices."""
    p_idx = jax.lax.axis_index(axis_name)
    key = jax.random.fold_in(key, p_idx)
    return jax.random.categorical(key, all_log_w, shape=(n_local,))


def _global_systematic(key, all_log_w, n_local, axis_name):
    """Globally coherent systematic comb: one shared uniform, device p takes
    strata [p*n_local, (p+1)*n_local)."""
    n = all_log_w.shape[0]
    p_idx = jax.lax.axis_index(axis_name)
    u0 = jax.random.uniform(key, (), dtype=all_log_w.dtype)  # same on all
    pos = (p_idx * n_local + jnp.arange(n_local, dtype=all_log_w.dtype)
           + u0) / n
    w = jnp.exp(all_log_w - jnp.max(all_log_w))
    cdf = jnp.cumsum(w / jnp.sum(w))
    idx = jnp.searchsorted(cdf, pos, side="left")
    return jnp.clip(idx, 0, n - 1)


_SHARD_RESAMPLERS = {
    "multinomial": _global_categorical,
    "systematic": _global_systematic,
}


def _global_ess_gate(all_w, ess_threshold):
    """(do_resample, carried_log_weights[N]) for globally-ESS-gated
    adaptive resampling (semantics of `ops.smoothers._ess_gate` on the
    gathered weights)."""
    n = all_w.shape[0]
    lwn = all_w - jax.scipy.special.logsumexp(all_w)
    ess = 1.0 / jnp.sum(jnp.exp(2.0 * lwn))
    do_res = ess < ess_threshold * n
    carried = lwn + jnp.log(jnp.asarray(float(n), all_w.dtype))
    return do_res, jnp.where(jnp.isfinite(carried), carried, 0.0)


def _local_row_chunks(bw_chunk: int | None, n_local: int):
    """Chunk count for streaming the local [N_loc, N] backward-weight block
    (mirrors `ops.smoothers._bw_row_chunks`, applied to the local rows)."""
    from ..ops.smoothers import _bw_row_chunks
    return _bw_row_chunks(bw_chunk, n_local)


def make_sharded_smoother_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                               smoother: str, axis_name: str = "particle",
                               resampler: str = "multinomial",
                               lambduh: float = 0.95, n_tilde: int = 2,
                               ess_threshold: float | None = None,
                               bw_chunk: int | None = None):
    """Smoother step over local particle shards with cross-device collectives.

    Carry arrays are the local shards: particles [N_loc, D], log_weights
    [N_loc], statistics [N_loc, H].

    Feature parity with the single-device steps (`ops/smoothers.py`):
    ``ess_threshold`` gates resampling on the *global* effective sample
    size; ``bw_chunk`` streams each device's [N_loc, N] backward-weight
    block in row chunks (the row decomposition composes with sharding:
    global rows are first split across devices, then chunked locally);
    ``paris`` draws ``n_tilde`` exact backward indices per row from the
    same block.
    """
    if resampler not in _SHARD_RESAMPLERS:
        raise ValueError(f"sharded resampler must be one of "
                         f"{sorted(_SHARD_RESAMPLERS)}")
    draw = _SHARD_RESAMPLERS[resampler]
    if smoother == "poyiadjis_N":
        smoother, lambduh = "nemeth", 1.0
    if smoother not in ("nemeth", "poyiadjis_N2", "paris", "filter"):
        raise ValueError(f"Unsupported sharded smoother '{smoother}'")

    def step(params, carry: PFCarry, inp: PFStepInput) -> PFCarry:
        n_local = carry.particles.shape[0]
        p_idx = jax.lax.axis_index(axis_name)
        # gather the global filter state (small: N x (D + 1 + H))
        all_x = jax.lax.all_gather(carry.particles, axis_name, tiled=True)
        all_w = jax.lax.all_gather(carry.log_weights, axis_name, tiled=True)

        key_res, key_prop, key_bs = jax.random.split(inp.key, 3)
        idx = draw(key_res, all_w, n_local, axis_name)
        if ess_threshold is not None:
            do_res, carried_all = _global_ess_gate(all_w, ess_threshold)
            own = p_idx * n_local + jnp.arange(n_local, dtype=idx.dtype)
            idx = jnp.where(do_res, idx, own)
        parents = jnp.take(all_x, idx, axis=0)
        key_prop = jax.random.fold_in(key_prop, p_idx)
        new_x = kernel.propose(params, key_prop, parents, inp.y)
        new_w = kernel.reweight(params, parents, new_x, inp.y)
        if ess_threshold is not None:
            carried_loc = jnp.take(carried_all, idx)
            new_w = new_w + jnp.where(do_res, 0.0, carried_loc)

        scale = inp.weight * inp.in_window

        if smoother == "filter":
            h = stat_fn(params, parents, new_x, inp.y, inp.t)  # [N_loc, H]
            all_new_w = jax.lax.all_gather(new_w, axis_name, tiled=True)
            probs_loc = jnp.exp(new_w - jnp.max(all_new_w))
            denom = jax.lax.psum(jnp.sum(probs_loc), axis_name)
            stats = carry.statistics + scale * jax.lax.psum(
                jnp.sum(h * (probs_loc / denom)[:, None], axis=0), axis_name)
        elif smoother == "nemeth":
            h = stat_fn(params, parents, new_x, inp.y, inp.t)  # [N_loc, H]
            all_s = jax.lax.all_gather(carry.statistics, axis_name,
                                       tiled=True)
            probs = jax.nn.softmax(all_w)
            S_bar = probs @ all_s                           # [H]
            stats = (lambduh * jnp.take(all_s, idx, axis=0)
                     + (1.0 - lambduh) * S_bar[None, :]
                     + scale * h)
        elif smoother == "poyiadjis_N2":
            # local [N_loc, N] block of backward weights, optionally
            # streamed in row chunks (O(chunk * N) live memory)
            all_s = jax.lax.all_gather(carry.statistics, axis_name,
                                       tiled=True)
            n_chunks = _local_row_chunks(bw_chunk, n_local)

            def rows_to_stats(x_next_c):
                def row(x_next_i):
                    x_b = jnp.broadcast_to(x_next_i[None, :], all_x.shape)
                    return all_w + kernel.prior_log_density(params, all_x,
                                                            x_b)

                log_bw = jax.vmap(row)(x_next_c)            # [C, N]
                bw = jax.nn.softmax(log_bw, axis=-1)
                smoothed = bw @ all_s                        # [C, H]

                def h_row(x_next_i, bw_row):
                    x_b = jnp.broadcast_to(x_next_i[None, :], all_x.shape)
                    hp = stat_fn(params, all_x, x_b, inp.y, inp.t)
                    return bw_row @ hp

                h_term = jax.vmap(h_row)(x_next_c, bw)
                return smoothed + scale * h_term

            if n_chunks == 1:
                stats = rows_to_stats(new_x)
            else:
                chunked = new_x.reshape(n_chunks, n_local // n_chunks,
                                        new_x.shape[-1])
                stats = jax.lax.map(rows_to_stats, chunked)
                stats = stats.reshape(n_local, stats.shape[-1])
        else:  # paris: exact backward sampling from the local BW block
            all_s = jax.lax.all_gather(carry.statistics, axis_name,
                                       tiled=True)
            n_chunks = _local_row_chunks(bw_chunk, n_local)
            bs_keys = jax.random.split(jax.random.fold_in(key_bs, p_idx),
                                       n_local)

            def rows_to_stats(args):
                x_next_c, keys_c = args

                def row(x_next_i):
                    x_b = jnp.broadcast_to(x_next_i[None, :], all_x.shape)
                    return all_w + kernel.prior_log_density(params, all_x,
                                                            x_b)

                log_bw = jax.vmap(row)(x_next_c)            # [C, N]
                J = jax.vmap(lambda k, lw: jax.random.categorical(
                    k, lw, shape=(n_tilde,)))(keys_c, log_bw)  # [C, K]
                rewired = jnp.take(all_s, J, axis=0)        # [C, K, H]

                def h_for(x_next_i, J_i):
                    xt = jnp.take(all_x, J_i, axis=0)       # [K, D]
                    x_b = jnp.broadcast_to(x_next_i[None, :], xt.shape)
                    return stat_fn(params, xt, x_b, inp.y, inp.t)

                hj = jax.vmap(h_for)(x_next_c, J)           # [C, K, H]
                return jnp.mean(rewired + scale * hj, axis=1)

            if n_chunks == 1:
                stats = rows_to_stats((new_x, bs_keys))
            else:
                C = n_local // n_chunks
                stats = jax.lax.map(rows_to_stats, (
                    new_x.reshape(n_chunks, C, new_x.shape[-1]),
                    bs_keys.reshape((n_chunks, C) + bs_keys.shape[1:])))
                stats = stats.reshape(n_local, stats.shape[-1])

        # global loglik increment log(mean(exp(new_w)))
        m = jax.lax.pmax(jnp.max(new_w), axis_name)
        total = jax.lax.psum(jnp.sum(jnp.exp(new_w - m)), axis_name)
        n_total = jax.lax.psum(jnp.asarray(n_local, new_w.dtype), axis_name)
        inc = m + jnp.log(total) - jnp.log(n_total)
        loglik = carry.loglik + inp.weight * inp.in_window * inc
        return PFCarry(new_x, new_w, stats, loglik)

    return step


def run_buffered_pf_sharded(kernel: ParticleKernel, stat_fn: StatisticFn,
                            params, observations, *, key, n_local: int,
                            statistic_dim: int, smoother: str = "poyiadjis_N",
                            step_weights=None, in_window=None,
                            prior_mean=0.0, prior_var=1.0,
                            resampler: str = "multinomial",
                            lambduh: float = 0.95, n_tilde: int = 2,
                            ess_threshold: float | None = None,
                            bw_chunk: int | None = None,
                            axis_name: str = "particle"):
    """Sharded analogue of `ops.buffered.run_buffered_pf`.

    Must be called inside a `shard_map` region with ``axis_name`` bound;
    returns (mean_statistic [H] (globally reduced), loglikelihood).
    """
    W = observations.shape[0]
    dtype = observations.dtype
    if step_weights is None:
        step_weights = jnp.ones((W,), dtype)
    if in_window is None:
        in_window = (step_weights > 0).astype(dtype)

    step = make_sharded_smoother_step(kernel, stat_fn, smoother, axis_name,
                                      resampler, lambduh, n_tilde,
                                      ess_threshold, bw_chunk)

    key_init, key_steps = jax.random.split(key)
    key_init = jax.random.fold_in(key_init, jax.lax.axis_index(axis_name))
    x0 = kernel.sample_x0(params, key_init, n_local, prior_mean, prior_var)
    x0 = x0.astype(dtype)
    carry0 = PFCarry(x0, jnp.zeros((n_local,), dtype),
                     jnp.zeros((n_local, statistic_dim), dtype)
                     if smoother != "filter"
                     else jnp.zeros((statistic_dim,), dtype),
                     jnp.zeros((), dtype))

    xs = PFStepInput(
        key=jax.random.split(key_steps, W),
        y=observations,
        weight=step_weights,
        in_window=in_window,
        t=jnp.arange(W, dtype=jnp.int32),
    )

    def body(carry, inp):
        return step(params, carry, inp), None

    carry, _ = jax.lax.scan(body, carry0, xs)

    if smoother == "filter":
        mean_stat = carry.statistics
    else:
        m = jax.lax.pmax(jnp.max(carry.log_weights), axis_name)
        w_loc = jnp.exp(carry.log_weights - m)
        denom = jax.lax.psum(jnp.sum(w_loc), axis_name)
        mean_stat = jax.lax.psum(
            jnp.sum(carry.statistics * w_loc[:, None], axis=0), axis_name
        ) / denom
    return mean_stat, carry.loglik
