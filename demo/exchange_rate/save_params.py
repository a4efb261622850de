"""Long-budget exchange-rate parameter-sampling runs (SGLD vs LD).

Reproduction of `save_svm_params.py` / `save_garch_params.py`
(`/root/reference/demo/exchange_rate/save_svm_params.py:56-91`): fit a
multi-sequence sampler over every segment of the exchange-rate series with
a wall-clock budget per leg —

  * SGLD: eps=1e-3, S=16, B=4, num_sequences=1, Poyiadjis O(N), N particles
  * LD:   eps=0.1, full sequences, num_sequences=-1, PaRIS, N particles

and save traces in the checkpoint format `calculate_ksd.py` consumes.

The reference budget is 8 hours per leg on a desktop; the default budget
here is --fit_time 600 (seconds) per leg — pass --fit_time 28800 for the
literal reference protocol.  Each leg runs whole-loop-compiled `fit_scan`
chunks of --chunk_iters iterations between wall-clock checks (one
dispatch and host sync per chunk, not per step).

Usage: python save_params.py [--model svm|garch|svjm] [--data PATH.npz]
    [--N 10000] [--fit_time SECONDS] [--out DIR]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="svm",
                    choices=["svm", "garch", "svjm"])
    ap.add_argument("--data", default=None)
    ap.add_argument("--N", type=int, default=10000)
    ap.add_argument("--fit_time", type=float, default=600.0,
                    help="wall-clock budget per leg, seconds "
                         "(reference: 28800)")
    ap.add_argument("--chunk_iters", type=int, default=2000,
                    help="iterations per compiled chunk for the SGLD leg")
    ap.add_argument("--ld_chunk_iters", type=int, default=None,
                    help="iterations per compiled chunk for the LD leg "
                         "(default: auto-scaled by total observation count; "
                         "the LD leg filters every full segment per "
                         "iteration, ~100x heavier than an SGLD "
                         "subsequence step)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from exchange_rate_demo import DEFAULT_DATA, load_segments

    from sgmcmc_tpu.inference.samplers import (SeqGARCHSampler,
                                               SeqSVJMSampler,
                                               SeqSVMSampler)
    from sgmcmc_tpu.io import checkpoint as ckpt

    out_dir = args.out or f"./eur_{args.model}_results"
    os.makedirs(os.path.join(out_dir, "samples"), exist_ok=True)

    segments = load_segments(args.data or DEFAULT_DATA, min_len=25)
    total_obs = sum(s.shape[0] for s in segments)
    print(f"{len(segments)} segments, {total_obs} observations")

    # Per-leg chunk sizes: the LD leg is ~total_obs/16 heavier per
    # iteration than the SGLD subsequence leg, so its chunks are shorter
    # (comparable time between wall-clock checks).
    ld_chunk = args.ld_chunk_iters
    if ld_chunk is None:
        ld_chunk = 200 if total_obs <= 1000 else 50

    cls = {"svm": SeqSVMSampler, "garch": SeqGARCHSampler,
           "svjm": SeqSVJMSampler}[args.model]
    sampler = cls(segments, seed=12345)
    sampler.project_parameters()

    legs = {
        "sgld": dict(epsilon=0.001, subsequence_length=16, buffer_length=4,
                     num_sequences=1, pf="poyiadjis_N", N=args.N,
                     resampler="systematic", resample_mode="auto"),
        "ld": dict(epsilon=0.1, subsequence_length=-1, num_sequences=-1,
                   pf="paris", N=args.N, resample_mode="auto"),
    }
    for name, kw in legs.items():
        eps = kw.pop("epsilon")
        # whole-chunk-compiled wall-clock fit with adaptive thinning
        # (bounds the host-side trace over the 8 h reference budget)
        chunk = args.chunk_iters if name == "sgld" else ld_chunk
        params_list, times = sampler.fit_timed(
            "SGLD", max_time=args.fit_time, epsilon=eps,
            chunk_iters=chunk, **kw)
        path = os.path.join(out_dir, "samples", f"{name}_trace.p")
        ckpt.save_trace(path, params_list, times)
        print(f"{name}: {len(params_list)} samples in {times[-1]:.0f}s "
              f"-> {path}")

    print(f"KSD: python calculate_ksd.py --model {args.model} --trace "
          f"{out_dir}/samples/sgld_trace.p {out_dir}/samples/ld_trace.p")


if __name__ == "__main__":
    main()
