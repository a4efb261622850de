"""Distributed SG-MCMC training step: chains x particles over a device mesh.

Composes the two parallel axes (SURVEY.md §2.4): many independent chains
sharded over the ``chain`` mesh axis (pure data parallelism, no cross-chain
communication) and each chain's particle filter sharded over the
``particle`` axis (cross-device collectives inside `pf_shard`).  The
whole update — subsequence sampling, buffered PF score, prior gradient,
Langevin noise, projection — is one `shard_map`-wrapped function that
jits once.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..inference.sgmcmc import (PFScoreConfig, _fused_eligible,
                                tree_random_normal)
from ..models.base import ParticleKernel, StatisticFn
from ..ops.buffered import window_weights
from ..ops.dispatch import pf_path
from ..ops.pallas.fused_pf import fused_pf_score
from ..ops.subsequence import sample_buffered_window, window_length
from .pf_shard import run_buffered_pf_sharded


def make_distributed_sgld_step(
        kernel: ParticleKernel, stat_fn: StatisticFn, statistic_dim: int,
        unpack, grad_logprior_fn, config: PFScoreConfig, T: int,
        mesh: Mesh, epsilon: float, prior_mean_var_fn=None,
        project_fn=None, is_scaled: bool = True, fused_model=None,
        island_fused: bool = False, warn_small_islands: bool = True):
    """Build step(keys [n_chains], params_stack, observations[T, m]).

    ``keys``/``params_stack`` have their chain axis sharded over the mesh's
    'chain' axis; observations are replicated.  Each chain's PF runs with
    N = config.n_particles split across the 'particle' axis.

    ``island_fused``: with a sharded particle axis, run the fused Pallas
    window kernel *per shard* as an island particle filter — each device
    runs an independent N/P-particle filter (its own resampling) and the
    per-island Fisher-identity scores / loglikelihoods are psum-averaged.
    This keeps the whole window inside one kernel under particle sharding
    at a statistical trade: the island estimator averages P independent
    N/P-particle scores instead of one N-particle score, so per-island
    smoother bias corresponds to the smaller island size (Vergé et al.
    2015 island PF).  Exact global resampling per step is incompatible
    with whole-window kernel fusion — collectives cannot run inside a
    Pallas call.
    """
    n_particle_shards = mesh.shape["particle"]
    if config.n_particles % n_particle_shards:
        raise ValueError("n_particles must divide the particle mesh axis")
    n_local = config.n_particles // n_particle_shards
    # the fused window kernel applies when the particle axis is unsharded,
    # or per-shard in island mode
    if n_particle_shards == 1:
        path = pf_path(config.resample_mode,
                       _fused_eligible(config, fused_model))
    elif island_fused:
        island_cfg = dataclasses.replace(config, n_particles=n_local)
        path = pf_path(config.resample_mode,
                       _fused_eligible(island_cfg, fused_model))
        if not path.fused:
            raise ValueError(
                "island_fused needs the fused window kernel: resample_mode "
                "'fused' or 'auto' on a platform that has it, and an "
                "eligible configuration with a power-of-two island size "
                f">= 16 (got {n_local} particles per device)")
    else:
        path = pf_path(config.resample_mode, False)
    use_fused = path.fused and n_particle_shards == 1
    use_island = path.fused and n_particle_shards > 1
    # ``warn_small_islands=False`` silences the bias warning for
    # deliberately-tiny shapes (dryruns / unit tests on toy configs)
    if use_island and n_local < 256 and warn_small_islands:
        import warnings
        warnings.warn(
            f"island_fused with island size {n_local} (< 256): the island "
            f"estimator's smoother bias is the Poyiadjis bias at "
            f"N = island size, which grows as islands shrink (~1/N decay; "
            f"per-model measured curves in scripts/island_bias_sweep.json "
            f"— LGSSM exact-Kalman oracle: >= 256 stays under the "
            f"reference's own Nemeth-lambda=0.95 trade, >= 512 ~ global "
            f"resampling; SVM N=2^20 oracle: >= 128 under the Nemeth "
            f"trade, >= 256 ~ global resampling).  Use >= 256 particles "
            f"per device, or disable island_fused for the "
            f"unbiased-at-full-N global-resampling estimator.",
            stacklevel=2)
    S = config.subsequence_length
    full = (S == -1) or (S >= T)
    W = T if full else window_length(S, config.buffer_length, T)
    scale = (1.0 / T) if is_scaled else 1.0

    def one_chain(key, params, observations):
        dtype = observations.dtype
        key_win, key_pf, key_noise = jax.random.split(key, 3)

        def one_window(k):
            kw, kp = jax.random.split(k)
            if full:
                window, step_w, in_win = (observations,
                                          jnp.ones((T,), dtype),
                                          jnp.ones((T,), dtype))
            else:
                win = sample_buffered_window(kw, S, config.buffer_length, T,
                                             config.partition_style, dtype)
                window = jax.lax.dynamic_slice_in_dim(
                    observations, win.window_start, W, axis=0)
                step_w, in_win = window_weights(win.t1, win.tL, win.weights,
                                                W, dtype)
            if prior_mean_var_fn is None:
                pm, pv = jnp.zeros((), dtype), jnp.asarray(10.0, dtype)
            else:
                pm, pv = prior_mean_var_fn(params)
            if use_fused or use_island:
                lam = 1.0 if config.smoother == "poyiadjis_N" \
                    else config.lambduh
                fused_kw = dict(lambduh=lam, interpret=path.interpret,
                                ess_threshold=config.ess_threshold)
                if use_fused:
                    return fused_pf_score(
                        fused_model, kp, params, window, step_w,
                        config.n_particles, pm, pv, **fused_kw)
                # island mode: independent per-shard filter, psum-averaged
                kp = jax.random.fold_in(kp,
                                        jax.lax.axis_index("particle"))
                stat, ll = fused_pf_score(
                    fused_model, kp, params, window, step_w, n_local,
                    pm, pv, **fused_kw)
                P = float(n_particle_shards)
                return (jax.lax.psum(stat, "particle") / P,
                        jax.lax.psum(ll, "particle") / P)
            return run_buffered_pf_sharded(
                kernel, stat_fn, params, window, key=kp, n_local=n_local,
                statistic_dim=statistic_dim, smoother=config.smoother,
                step_weights=step_w, in_window=in_win,
                prior_mean=pm, prior_var=pv, resampler=config.resampler,
                lambduh=config.lambduh, n_tilde=config.n_tilde,
                ess_threshold=config.ess_threshold,
                bw_chunk=config.bw_chunk)

        stats, logliks = jax.vmap(one_window)(
            jax.random.split(key_pf, config.minibatch_size))
        grad_ll = unpack(jnp.mean(stats, axis=0))
        grad = jax.tree_util.tree_map(
            lambda a, b: scale * (a + b), grad_ll, grad_logprior_fn(params))
        noise = tree_random_normal(key_noise, params, scale)
        new = jax.tree_util.tree_map(
            lambda p, g, n: p + epsilon * g + jnp.sqrt(2.0 * epsilon) * n,
            params, grad, noise)
        if project_fn is not None:
            new = project_fn(new)
        return new, jnp.mean(logliks)

    def local_fn(keys_loc, params_loc, observations):
        return jax.vmap(one_chain, in_axes=(0, 0, None))(
            keys_loc, params_loc, observations)

    return shard_map(
        local_fn, mesh=mesh,
        in_specs=(P("chain"), P("chain"), P()),
        out_specs=(P("chain"), P("chain")),
        check_vma=False,
    )


def make_distributed_fit(step, num_iters: int):
    """Scan ``num_iters`` distributed steps under one jit."""
    def fit(keys, params_stack, observations):
        def body(params, i):
            step_keys = jax.vmap(lambda k: jax.random.fold_in(k, i))(keys)
            params, ll = step(step_keys, params, observations)
            return params, ll

        return jax.lax.scan(body, params_stack,
                            jnp.arange(num_iters, dtype=jnp.int32))

    return jax.jit(fit)


def make_distributed_fit_recorded(step, num_iters: int,
                                  steps_per_iter: int = 1,
                                  output_all: bool = True):
    """`make_distributed_fit` with the `inference.sgmcmc.fit` recording
    conventions (the `Sampler.fit_scan(mesh=...)` backend): ``num_iters``
    recorded iterations of ``steps_per_iter`` inner steps each.

    Returns fit(keys [C, 2], params_stack, observations) ->
    (final params, trace with leaves [num_iters, C, ...] or None,
    loglik aux [num_iters, C]).
    """
    def fit(keys, params_stack, observations):
        def one_iter(params, i):
            def one_step(p, j):
                step_keys = jax.vmap(
                    lambda k: jax.random.fold_in(
                        k, i * steps_per_iter + j))(keys)
                return step(step_keys, p, observations)

            params, lls = jax.lax.scan(
                one_step, params,
                jnp.arange(steps_per_iter, dtype=jnp.int32))
            out = (params, lls[-1]) if output_all else lls[-1]
            return params, out

        params, outputs = jax.lax.scan(
            one_iter, params_stack,
            jnp.arange(num_iters, dtype=jnp.int32))
        if output_all:
            trace, aux = outputs
            return params, trace, aux
        return params, None, outputs

    return jax.jit(fit)
