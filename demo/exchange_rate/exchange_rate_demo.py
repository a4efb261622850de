"""EUR/US exchange-rate SVM demo: SGLD vs full-sequence LD.

Reproduction of the reference workflow
(`/root/reference/demo/exchange_rate/exchange_rate_single_demo.py` and
`save_svm_params.py`): load hourly demeaned log-returns, scale x1000, split
segments at >6h gaps, fit the SVM on one segment with

  * SGLD: eps=1e-3, S=16, B=4, Poyiadjis O(N) with N particles,
  * LD:   eps=0.1, full sequence, PaRIS smoother,

then save parameter traces and the smoothed volatility path.

`--mode subset|full` reproduces the multi-segment workflows
(`exchange_rate_subset_demo.py` / `exchange_rate_full_demo.py`): a
`SeqSVMSampler`/`SeqGARCHSampler` over the first 5 / all segments, SGLD
with one random segment + subsequence per step (num_sequences=1) vs LD
over every full segment (num_sequences=-1, S=-1).  The GBP variant
(`exchange_rate_demo_gbp.py`) is `--data <EURGBP npz>`.

Usage:
  python exchange_rate_demo.py [--data PATH.npz] [--model svm|garch]
      [--mode single|subset|full] [--N PARTICLES] [--segment IDX]
      [--sgld_iters K] [--ld_iters K] [--out DIR]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

DEFAULT_DATA = "/root/reference/data/EURUS_processed.npz"


def load_segments(path: str, min_len: int = 7):
    """Hourly log-returns x1000, split at >6h gaps
    (`exchange_rate_single_demo.py:16-45`)."""
    data = np.load(path)
    returns = np.asarray(data["hourly_log_returns"], dtype=np.float64)
    dates = np.asarray(data["hourly_date"])
    observations = returns.reshape(-1, 1) * 1000.0
    gaps = np.where(np.diff(dates) > np.timedelta64(6, "h"))[0].tolist()
    segments = []
    for start, end in zip([0] + gaps, gaps + [observations.shape[0]]):
        if end - start > min_len:
            segments.append(observations[start:end])
    return segments


def fit_model(model_name, observations, method, num_iters, N, seed=12345,
              seq: bool = False, chunk_iters: int = 250,
              n_particle_devices: int = 1):
    """Whole-loop-compiled fit in chunked program executions
    (`fit_scan_chunked`): per-step Python calls pay one dispatch and host
    sync each, while chunks of a few hundred iterations compile once and
    bound the on-device trace.

    ``seq=True`` fits a multi-sequence sampler over a list of segments
    (`SeqSVMSampler`; SGLD draws one segment per step, LD sums every full
    segment — `exchange_rate_subset_demo.py:92-115`).
    """
    from sgmcmc_tpu.inference.samplers import (GARCHSampler, SeqGARCHSampler,
                                               SeqSVJMSampler, SeqSVMSampler,
                                               SVJMSampler, SVMSampler)
    if seq:
        cls = {"svm": SeqSVMSampler, "svjm": SeqSVJMSampler,
               "garch": SeqGARCHSampler}[model_name]
        sampler = cls(observations, seed=seed)
    else:
        cls = {"svm": SVMSampler, "svjm": SVJMSampler,
               "garch": GARCHSampler}[model_name]
        sampler = cls(observations=observations, seed=seed)
    sampler.project_parameters()
    if method == "sgld":
        kwargs = dict(epsilon=0.001, subsequence_length=16, buffer_length=4,
                      pf="poyiadjis_N", N=N, resample_mode="auto",
                      resampler="systematic")
        if seq:
            kwargs["num_sequences"] = 1
    else:  # full-sequence Langevin dynamics
        kwargs = dict(epsilon=0.1, subsequence_length=-1, pf="paris", N=N,
                      resample_mode="auto")
        if seq:
            kwargs["num_sequences"] = -1
    if n_particle_devices > 1:
        # public multi-chip path: shard this one chain's particle filter
        # over a 1 x P (chain x particle) mesh
        # (`fit_scan(mesh=..., num_chains=1)`; single-segment samplers
        # only — the Seq samplers' padded multi-sequence grad is not the
        # distributed step's contract)
        if seq:
            raise ValueError("--n_particle_devices needs --mode single")
        import jax
        from sgmcmc_tpu.io.checkpoint import unstack_trace
        from sgmcmc_tpu.parallel import sharding
        P = n_particle_devices
        mesh = sharding.make_mesh(n_chain_devices=1,
                                  n_particle_devices=P,
                                  devices=jax.devices()[:P])
        stacked = sampler.fit_scan_chunked(
            "SGLD", num_iters=num_iters, chunk_iters=chunk_iters,
            num_chains=1, mesh=mesh, **kwargs)
        params_list = unstack_trace(
            jax.tree_util.tree_map(lambda x: x[0], stacked))
        return sampler, params_list, list(range(len(params_list)))
    params_list = sampler.fit_scan_chunked(
        "SGLD", num_iters=num_iters, chunk_iters=chunk_iters, **kwargs)
    times = list(range(len(params_list)))
    return sampler, params_list, times


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=DEFAULT_DATA)
    ap.add_argument("--model", default="svm",
                    choices=["svm", "svjm", "garch"])
    ap.add_argument("--mode", default="single",
                    choices=["single", "subset", "full"])
    ap.add_argument("--sgld_iters", type=int, default=20000)
    ap.add_argument("--ld_iters", type=int, default=2000)
    ap.add_argument("--N", type=int, default=1000)
    ap.add_argument("--n_particle_devices", type=int, default=1,
                    help="shard the particle filter over P mesh devices "
                         "(fit_scan(mesh=...) public multi-chip path; "
                         "--mode single only)")
    ap.add_argument("--segment", type=int, default=1)
    ap.add_argument("--out", default="./exchange_out")
    args = ap.parse_args()

    from sgmcmc_tpu.io import checkpoint as ckpt

    seq = args.mode != "single"
    # multi-sequence modes need every segment to fit one S=16/B=4 window
    segments = load_segments(args.data, min_len=25 if seq else 7)
    if args.mode == "single":
        print(f"{len(segments)} segments; using segment {args.segment} "
              f"with {segments[args.segment].shape[0]} observations")
        obs = segments[args.segment]
    else:
        obs = segments[:5] if args.mode == "subset" else segments
        print(f"{args.mode}: {len(obs)} segments, "
              f"{sum(s.shape[0] for s in obs)} total observations")

    total_obs = (obs.shape[0] if args.mode == "single"
                 else sum(s.shape[0] for s in obs))
    results = {}
    for method in ["sgld", "ld"]:
        t0 = time.time()
        iters = args.sgld_iters if method == "sgld" else args.ld_iters
        # chunk sizes sized to keep single program executions well under
        # the remote worker's watchdog (LD iterations scale with the total
        # observation count: every full segment each step)
        chunk = 2000 if method == "sgld" else (200 if total_obs <= 1000
                                               else 50)
        sampler, params_list, times = fit_model(
            args.model, obs, method, iters, args.N, seq=seq,
            chunk_iters=chunk,
            n_particle_devices=args.n_particle_devices)
        print(f"{method}: {len(params_list)} samples in "
              f"{time.time() - t0:.1f}s; final loglik "
              f"{sampler.noisy_loglikelihood(N=args.N, pf='filter'):.2f}")
        results[method] = (params_list, times)
        ckpt.save_trace(os.path.join(
            args.out, f"{args.model}_{method}_trace.p"), params_list, times)

    # trace summary (single batched host transfer per trace)
    from sgmcmc_tpu.io.checkpoint import stack_trace
    for method, (params_list, _) in results.items():
        burn = len(params_list) // 3
        stacked = stack_trace(params_list[burn:])
        if args.model in ("svm", "svjm"):
            phi = float(np.mean(stacked.A[:, 0, 0]))
            sigma = float(np.mean(1.0 / np.abs(stacked.LQinv_vec[:, 0])))
            tau = float(np.mean(1.0 / np.abs(stacked.LRinv_vec[:, 0])))
            line = f"{method}: phi={phi:.4f} sigma={sigma:.4f} tau={tau:.4f}"
            if args.model == "svjm":
                pj = float(np.mean(1.0 / (1.0 + np.exp(
                    -stacked.logit_pJ[:, 0]))))
                sj = float(np.mean(1.0 / np.abs(stacked.LQJinv_vec[:, 0])))
                line += f" pJ={pj:.4f} sigmaJ={sj:.4f}"
            print(line)
        else:
            mu = float(np.mean(np.exp(stacked.log_mu[:, 0])))
            print(f"{method}: mu={mu:.4f}")


if __name__ == "__main__":
    main()
