#!/usr/bin/env python3
"""Smoke test of sgmcmc_tpu's main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-5 below
    python chip_smoke.py --devices 4   # four cards: the multi-device phases

Phases (one card), in order; any failure exits non-zero:

1. Device identity: ``jax.devices()`` and the card's name and power limit.
   Exits non-zero, printing no result, when JAX finds no GPU.
2. The flagship fit through the public API: ``SVMSampler.fit_scan("SGLD",
   num_chains=8192)`` with N=1024 particles, the Poyiadjis O(N) smoother,
   systematic resampling, S=40/B=10 (window W=60), T=1000.  Checks finite
   parameters and log-likelihoods and that A moves toward the truth.
3. The fused window kernel, compiled for the card, against the plain
   gather path (`run_buffered_pf(resample_mode="gather")`) at N=1024,
   W=60 on a batch of chains fed the same pre-drawn randomness.
4. The correctness oracle: the LGSSM PF score against the exact Kalman
   gradient, in float32.
5. The tests marked ``gpu``, run in this process with ``pytest.main``.

With ``--devices 4``: chain-sharded flagship chains over four cards
against the same keys on one card, and one particle-sharded filter (the
global systematic comb, `parallel/pf_shard.py`) against the single-device
filter.

Reference comparisons run under ``jax.default_matmul_precision("highest")``
so no float32 product drops to TF32.  The last line of output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from sgmcmc_tpu.utils.runtime import (card_identity, enable_compile_cache,
                                      require_gpu)

REPO = os.path.dirname(os.path.abspath(__file__))


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# phase 2: the flagship fit
# ---------------------------------------------------------------------------

def phase_flagship(card: str, n_chains=8192, n_particles=1024, T=1000,
                   subseq=40, buffer=10, iters=20, seed=0) -> dict:
    from sgmcmc_tpu.inference.samplers import SVMSampler
    from sgmcmc_tpu.models import svm

    true_A, init_A = 0.9, 0.5
    ys, _ = svm.generate_data(jax.random.PRNGKey(seed),
                              svm.from_scalars(A=true_A, Q=0.5, R=1.0), T)
    sampler = SVMSampler(observations=ys, seed=seed + 2)
    sampler.parameters = svm.from_scalars(A=init_A, Q=1.0, R=2.0)
    kw = dict(N=n_particles, subsequence_length=subseq, buffer_length=buffer,
              pf="poyiadjis_N", resampler="systematic", resample_mode="auto")

    def run():
        return jax.block_until_ready(sampler.fit_scan(
            "SGLD", num_iters=iters, epsilon=0.1, num_chains=n_chains,
            record="all", return_aux=True, **kw))

    t0 = time.perf_counter()
    run()                                  # compile + first chunk
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    trace, ll = run()                      # the chains continue
    dt = time.perf_counter() - t0

    A = np.asarray(trace.A).reshape(n_chains, iters)
    finite_params = all(bool(np.all(np.isfinite(np.asarray(x))))
                        for x in jax.tree_util.tree_leaves(sampler.parameters))
    finite_ll = bool(np.all(np.isfinite(np.asarray(ll))))
    A_end = float(A[:, -1].mean())
    rate = n_chains * iters / dt
    log(f"[flagship] {2 * iters} SGLD iterations x {n_chains} chains, "
        f"N={n_particles}, S={subseq}/B={buffer}, T={T}")
    log(f"[flagship] finite params {finite_params}, finite loglik "
        f"{finite_ll}; mean A trace end {A.mean(0)[-5:].round(4).tolist()} "
        f"(init {init_A}, truth {true_A})")
    log(f"[flagship] compile ~{first - dt:.1f} s; {rate:.1f} aggregate SGLD "
        f"steps/s on {card}")
    runner = next(v for k, v in sampler._cache.items() if k[0] == "fit_scan")
    compiled = runner.lower(jax.random.PRNGKey(0), sampler.parameters,
                            sampler.observations).compile()
    log(f"[flagship] step memory_analysis: {compiled.memory_analysis()}")
    if not (finite_params and finite_ll):
        raise RuntimeError("flagship fit produced non-finite values")
    if not abs(A_end - true_A) < abs(init_A - true_A):
        raise RuntimeError(f"A did not move toward the truth: {A_end}")
    return dict(steps_per_s=rate, A_end=A_end)


# ---------------------------------------------------------------------------
# phase 3: window kernel vs the plain gather path, same randomness
# ---------------------------------------------------------------------------

def phase_kernel_vs_reference(n_chains=2048, n_particles=1024, W=60,
                              interpret=False, seed=0) -> dict:
    """Same pre-drawn randomness into both paths.  Tolerances (float32):

    * W=1 (one resampling step): per chain, statistics and log-likelihood
      agree to rtol 1e-4 on >= 99% of chains;
    * full window: with N=1024 in float32 the two paths' CDFs differ in
      their summation order, which flips some ancestors between adjacent
      particles; the estimator is unchanged in law, so the per-chain
      (paired) differences must average to zero within 4 standard errors
      and the spread across chains must agree within 10%.
    """
    from sgmcmc_tpu.models import svm
    from sgmcmc_tpu.ops.buffered import run_buffered_pf
    from sgmcmc_tpu.ops.pallas.fused_pf import fused_window_batched

    N = n_particles
    params = svm.from_scalars(A=0.9, Q=0.5, R=1.0)
    ys, _ = svm.generate_data(jax.random.PRNGKey(seed + 1), params, W + 100)
    pv = float(svm.stationary_variance(params))
    keys = jax.random.split(jax.random.PRNGKey(seed), n_chains)
    pvec = jnp.broadcast_to(
        svm._fused_pack(params).astype(jnp.float32).reshape(1, -1),
        (n_chains, 3))

    def compare(Wn):
        window = jnp.asarray(ys[100:100 + Wn], jnp.float32)

        def draws(key):        # run_buffered_pf's own PRNG consumption
            key_init, key_steps = jax.random.split(key)
            x0 = jnp.sqrt(pv) * jax.random.normal(key_init, (N, 1),
                                                  jnp.float32)
            ks = jax.vmap(jax.random.split)(jax.random.split(key_steps, Wn))
            xi = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(
                ks[:, 0])
            z = jax.vmap(lambda k: jax.random.normal(k, (N, 1), jnp.float32)
                         [:, 0])(ks[:, 1])
            return x0[:, 0][None], z[:, None, :], xi

        x0, z, xi = jax.jit(jax.vmap(draws))(keys)
        ms, ll = fused_window_batched(
            svm.FUSED, pvec, x0, z, jnp.broadcast_to(window[:, 0],
                                                     (n_chains, Wn)),
            jnp.ones((n_chains, Wn), jnp.float32), xi, interpret=interpret)
        ref = jax.jit(jax.vmap(lambda k: run_buffered_pf(
            svm.KERNEL, svm.grad_statistic, params, window, key=k,
            n_particles=N, statistic_dim=svm.STATISTIC_DIM,
            smoother="poyiadjis_N", resampler="systematic",
            resample_mode="gather", prior_mean=0.0, prior_var=pv)))(keys)
        a = np.column_stack([np.asarray(ms), np.asarray(ll)])
        b = np.column_stack([np.asarray(ref.mean_statistic),
                             np.asarray(ref.loglikelihood)])
        return a.astype(np.float64), b.astype(np.float64)

    with jax.default_matmul_precision("highest"):
        a1, b1 = compare(1)
        close = np.all(np.abs(a1 - b1) <= 1e-4 * (np.abs(b1) + 1.0), axis=1)
        a, b = compare(W)
    d = a - b
    se = d.std(0) / np.sqrt(n_chains)
    z = np.abs(d.mean(0)) / (se + 1e-12)
    bias_ok = np.all(np.abs(d.mean(0)) <= 4 * se + 1e-5 * (np.abs(b).mean(0)
                                                           + 1.0))
    spread = a.std(0) / np.maximum(b.std(0), 1e-12)
    log(f"[kernel] W=1: {close.mean():.4f} of {n_chains} chains agree to "
        f"rtol 1e-4")
    log(f"[kernel] W={W}, N={N}: paired mean difference / se per output "
        f"(3 statistics, loglik) {z.round(2).tolist()}; spread ratio "
        f"{spread.round(4).tolist()}")
    if close.mean() < 0.99:
        raise RuntimeError("kernel disagrees with gather at W=1")
    if not bias_ok or not np.all(np.abs(spread - 1.0) < 0.10):
        raise RuntimeError("kernel disagrees with gather in distribution")
    return dict(w1_agree=float(close.mean()), z=z.tolist())


# ---------------------------------------------------------------------------
# phase 4: LGSSM PF score vs the exact Kalman gradient
# ---------------------------------------------------------------------------

def phase_kalman_oracle(n_particles=1024, reps=512, T=32, seed=0,
                        modes=("auto", "gather")) -> dict:
    """f32 PF score (mean over ``reps`` independent filters) vs the exact
    Kalman gradient: |mean - exact| < 5 se + 2% |exact| per coordinate
    (the O(N) smoother's path-degeneracy bias is well inside 2% here)."""
    from sgmcmc_tpu.inference import sgmcmc
    from sgmcmc_tpu.models import lgssm
    from sgmcmc_tpu.models.registry import get_model

    api = get_model("lgssm")
    out = {}
    with jax.default_matmul_precision("highest"):
        params = lgssm.from_matrices(A=[[0.8]], C=[[1.0]], Q=[[0.5]],
                                     R=[[1.0]], dtype=jnp.float32)
        ys, _ = lgssm.generate_data(jax.random.PRNGKey(seed), params, T)
        ys = jnp.asarray(ys, jnp.float32)
        exact = jax.jit(lgssm.gradient_marginal_loglikelihood)(params, ys)
        exact_vec = np.concatenate([np.ravel(x) for x in
                                    jax.tree_util.tree_leaves(exact)])
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), reps)
        for mode in modes:
            cfg = sgmcmc.PFScoreConfig(
                n_particles=n_particles, smoother="poyiadjis_N",
                resampler="systematic", resample_mode=mode)
            score = sgmcmc.make_pf_score_fn(
                api.get_kernel(None), api.grad_statistic,
                api.grad_statistic_dim, api.unpack_grad, cfg, T,
                prior_mean_var_fn=api.prior_mean_var,
                fused_model=api.get_fused(None))
            grads, _ = jax.jit(jax.vmap(lambda k: score(k, params, ys)))(keys)
            g = np.column_stack([np.asarray(x).reshape(reps, -1)
                                 for x in jax.tree_util.tree_leaves(grads)])
            mean, se = g.mean(0), g.std(0) / np.sqrt(reps)
            err = np.abs(mean - exact_vec)
            ok = bool(np.all(err < 5 * se + 0.02 * np.abs(exact_vec)))
            log(f"[oracle] resample_mode={mode}: PF {mean.round(4).tolist()}"
                f" vs Kalman {exact_vec.round(4).tolist()} "
                f"(|err|/se {(err / se).round(2).tolist()})")
            if not ok:
                raise RuntimeError(f"PF score off the Kalman oracle ({mode})")
            out[mode] = (err / se).tolist()
    return out


# ---------------------------------------------------------------------------
# phase 5: the gpu-marked tests, in this process
# ---------------------------------------------------------------------------

class _Outcomes:
    def __init__(self):
        self.counts = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome,
                                                          0) + 1


def phase_gpu_tests() -> dict:
    import pytest
    os.environ["SGMCMC_TESTS_ON_DEVICE"] = "1"
    rec = _Outcomes()
    code = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                        os.path.join(REPO, "tests", "test_gpu.py")],
                       plugins=[rec])
    log(f"[gpu tests] exit {int(code)}, outcomes {rec.counts}")
    if code != 0 or rec.counts.get("passed", 0) == 0 or \
            set(rec.counts) - {"passed"}:
        raise RuntimeError("gpu-marked tests did not all pass")
    return rec.counts


# ---------------------------------------------------------------------------
# --devices 4: the multi-device paths
# ---------------------------------------------------------------------------

def phase_chain_sharded(devices, n_chains=8192, n_particles=1024, T=1000,
                        subseq=40, buffer=10, iters=5, seed=0) -> dict:
    """Chains sharded over len(devices) devices vs the same keys on one
    device (`fit_scan(mesh=...)`): every chain runs the same program on
    the same data, so they agree to float tolerance (rtol 1e-5)."""
    from sgmcmc_tpu.inference.samplers import SVMSampler
    from sgmcmc_tpu.models import svm
    from sgmcmc_tpu.parallel import sharding

    ys, _ = svm.generate_data(jax.random.PRNGKey(seed),
                              svm.from_scalars(A=0.9, Q=0.5, R=1.0), T)
    kw = dict(N=n_particles, subsequence_length=subseq, buffer_length=buffer,
              pf="poyiadjis_N", resampler="systematic", resample_mode="auto",
              record="none", return_aux=True)
    out = {}
    for name, devs in (("sharded", devices), ("single", devices[:1])):
        mesh = sharding.make_mesh(n_chain_devices=len(devs),
                                  n_particle_devices=1, devices=devs)
        s = SVMSampler(observations=ys, seed=seed + 2)
        s.parameters = svm.from_scalars(A=0.5, Q=1.0, R=2.0)
        t0 = time.perf_counter()
        _, ll = jax.block_until_ready(s.fit_scan(
            "SGLD", num_iters=iters, epsilon=0.1, num_chains=n_chains,
            mesh=mesh, **kw))
        out[name] = (np.asarray(s.parameters.A).ravel(), np.asarray(ll))
        log(f"[chain-sharded] {name} on {len(devs)} device(s): "
            f"{time.perf_counter() - t0:.1f} s incl. compile")
    (a_s, ll_s), (a_1, ll_1) = out["sharded"], out["single"]
    err = max(float(np.max(np.abs(a_s - a_1) / (np.abs(a_1) + 1e-3))),
              float(np.max(np.abs(ll_s - ll_1) / (np.abs(ll_1) + 1e-3))))
    log(f"[chain-sharded] {n_chains} chains x {iters} SGLD steps: max rel "
        f"difference sharded vs single device {err:.3g}")
    if not (np.all(np.isfinite(ll_s)) and err < 1e-5):
        raise RuntimeError("chain-sharded fit disagrees with one device")
    return dict(max_rel_diff=err)


def phase_particle_sharded(devices, n_particles=1 << 16, T=100, reps=16,
                           seed=0) -> dict:
    """One chain's filter with its particles sharded over the devices
    (global systematic comb) vs the single-device filter.  The two use
    different random streams, so they agree within Monte-Carlo error:
    |mean difference| < 5 se over ``reps`` replicates for the score and
    the log-likelihood, and the log-likelihood is within 5 se of the
    exact Kalman value."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from sgmcmc_tpu.models import lgssm
    from sgmcmc_tpu.ops.buffered import run_buffered_pf
    from sgmcmc_tpu.parallel import sharding
    from sgmcmc_tpu.parallel.pf_shard import run_buffered_pf_sharded

    n_dev = len(devices)
    mesh = sharding.make_mesh(n_chain_devices=1, n_particle_devices=n_dev,
                              devices=devices)
    with jax.default_matmul_precision("highest"):
        params = lgssm.from_matrices(A=[[0.8]], C=[[1.0]], Q=[[0.5]],
                                     R=[[1.0]], dtype=jnp.float32)
        ys, _ = lgssm.generate_data(jax.random.PRNGKey(seed), params, T)
        ys = jnp.asarray(ys, jnp.float32)
        exact_ll = float(lgssm.marginal_loglikelihood(params, ys))
        common = dict(statistic_dim=lgssm.statistic_dim(1, 1),
                      smoother="poyiadjis_N", resampler="systematic",
                      prior_mean=jnp.zeros(1, jnp.float32),
                      prior_var=10.0 * jnp.eye(1, dtype=jnp.float32))
        kern = lgssm.get_kernel("optimal")

        def local(key):
            return run_buffered_pf_sharded(
                kern, lgssm.grad_statistic, params, ys, key=key,
                n_local=n_particles // n_dev, **common)

        sharded = jax.jit(shard_map(local, mesh=mesh, in_specs=P(),
                                    out_specs=(P(), P()), check_vma=False))

        def single(key):
            out = run_buffered_pf(kern, lgssm.grad_statistic, params, ys,
                                  key=key, n_particles=n_particles, **common)
            return out.mean_statistic, out.loglikelihood

        single = jax.jit(single)
        res = {"sharded": [], "single": []}
        for i in range(reps):
            for name, f in (("sharded", sharded), ("single", single)):
                stat, ll = f(jax.random.PRNGKey(100 + 2 * i
                                                + (name == "single")))
                res[name].append(np.append(np.asarray(stat), float(ll)))
    s, g = np.array(res["sharded"]), np.array(res["single"])
    se = np.sqrt(s.var(0) / reps + g.var(0) / reps)
    z = np.abs(s.mean(0) - g.mean(0)) / (se + 1e-12)
    z_exact = abs(s[:, -1].mean() - exact_ll) / (s[:, -1].std()
                                                 / np.sqrt(reps) + 1e-12)
    log(f"[particle-sharded] N={n_particles} over {n_dev} devices vs one "
        f"device, {reps} replicates: |mean diff|/se {z.round(2).tolist()}; "
        f"loglik {s[:, -1].mean():.3f} vs Kalman {exact_ll:.3f} "
        f"({z_exact:.2f} se)")
    if not (np.all(z < 5) and z_exact < 5):
        raise RuntimeError("particle-sharded filter off the single-device "
                           "filter")
    return dict(z=z.tolist(), z_exact=float(z_exact))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=[1, 4],
                    help="4: run only the multi-device phases on 4 cards")
    args = ap.parse_args(argv)

    enable_compile_cache()
    devices = jax.devices()
    require_gpu(devices)
    card = card_identity()
    log(f"[device] {devices}")
    log(f"[device] nvidia-smi name, power.limit: {card}")
    if args.devices == 4:
        if len(devices) < 4:
            raise SystemExit(f"--devices 4 needs four GPUs, found "
                             f"{len(devices)}")
        phase_chain_sharded(devices[:4])
        phase_particle_sharded(devices[:4])
        count = 4
    else:
        phase_flagship(card.splitlines()[0])
        phase_kernel_vs_reference()
        phase_kalman_oracle()
        phase_gpu_tests()
        count = 1
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)


if __name__ == "__main__":
    main()
