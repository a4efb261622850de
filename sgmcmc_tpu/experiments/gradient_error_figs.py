"""Gradient-bias-vs-buffer-size figures (the paper's core claim).

Accelerator reproduction of the reference's
`gradient_error_fig_scripts/{lgssm,svm,garch}_grad_compare.py`: fix theta at
truth, pick a centered subsequence of length L in a series of length T,
compute a ground-truth gradient (LGSSM: exact buffered Kalman; SVM/GARCH:
Poyiadjis with very large N averaged over reps), then sweep buffer sizes x
particle counts x replications of the buffered PF gradient and report
mean absolute bias / MSE per parameter.

On the device all (buffer, N, rep) cells vmap/batch; the reference's 50x50 grid of
sequential NumPy PFs becomes a handful of jitted batched calls.

Usage: python -m sgmcmc_tpu.experiments.gradient_error_figs --model svm
"""
from __future__ import annotations

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from ..models.registry import get_model
from ..ops import buffered
from ..ops.subsequence import subsequence_weights


# Above this many particles, replicates run as separate device programs
# instead of one vmapped batch, bounding the live window-scan memory to one
# replicate's [N, ...] carries.
SEQUENTIAL_REP_N = 200_000


def pf_gradient_batch(model, params, window, step_w, in_win, keys, N,
                      smoother="poyiadjis_N", resample_mode="auto"):
    def one(k):
        out = buffered.run_buffered_pf(
            model.get_kernel(None), model.grad_statistic, params, window,
            key=k, n_particles=N, statistic_dim=model.grad_statistic_dim,
            smoother=smoother, step_weights=step_w, in_window=in_win,
            prior_mean=model.prior_mean_var(params)[0],
            prior_var=model.prior_mean_var(params)[1],
            resampler="systematic", resample_mode=resample_mode)
        return out.mean_statistic

    if N > SEQUENTIAL_REP_N:
        one_jit = jax.jit(one)
        return jnp.stack([one_jit(k) for k in keys])
    return jax.jit(jax.vmap(one))(keys)


def run(model_name: str = "svm", T: int = 100, L: int = 16,
        buffer_sizes=(0, 2, 3, 5, 10, 12, 15, 18, 20),
        particle_counts=(100, 1000), reps: int = 20,
        truth_N: int = 100000, truth_reps: int = 4, seed: int = 0,
        out_dir: str = "./grad_error_out", resample_mode="auto"):
    model = get_model(model_name)
    from ..experiments.driver import _make_true_params
    params = _make_true_params(model_name, dtype=jnp.float32)
    key = jax.random.PRNGKey(seed)
    ys, _ = model.generate_data(jax.random.fold_in(key, 0), params, T)
    start = (T - L) // 2
    w = subsequence_weights(start, L, T, "uniform", ys.dtype)

    # ---- ground truth ----------------------------------------------------
    if model.has_exact and model_name == "lgssm":
        from ..models import lgssm as lgssm_mod
        from ..ops import kalman
        fmsg = kalman.forward_message(
            ys[:start], params.A, params.C, params.LQinv, params.LRinv,
            lgssm_mod.default_forward_message(params))
        bmsg = kalman.backward_message(
            ys[start + L:], params.A, params.C, params.LQinv, params.LRinv,
            lgssm_mod.default_backward_message(params))
        g = lgssm_mod.gradient_marginal_loglikelihood(
            params, ys[start:start + L], forward_msg=fmsg,
            backward_msg=bmsg, weights=w)
        truth = np.concatenate([
            np.asarray(g.LRinv_vec), np.asarray(g.LQinv_vec),
            np.asarray(g.C).ravel(), np.asarray(g.A).ravel()])
    else:
        # Poyiadjis with huge N over the full window (B = T)
        step_w_full = np.zeros(T, np.float32)
        step_w_full[start:start + L] = np.asarray(w)
        in_win = (step_w_full > 0).astype(np.float32)
        stats = pf_gradient_batch(
            model, params, ys, jnp.asarray(step_w_full),
            jnp.asarray(in_win),
            jax.random.split(jax.random.fold_in(key, 1), truth_reps),
            truth_N, resample_mode=resample_mode)
        truth = np.asarray(stats).mean(axis=0)

    # ---- sweep -----------------------------------------------------------
    rows = []
    for B in buffer_sizes:
        lo, hi = max(0, start - B), min(T, start + L + B)
        window = ys[lo:hi]
        step_w = np.zeros(hi - lo, np.float32)
        step_w[start - lo:start - lo + L] = np.asarray(w)
        in_win = (step_w > 0).astype(np.float32)
        for N in particle_counts:
            stats = np.asarray(pf_gradient_batch(
                model, params, window, jnp.asarray(step_w),
                jnp.asarray(in_win),
                jax.random.split(jax.random.fold_in(key, 100 + B * 31 + N),
                                 reps), N, resample_mode=resample_mode))
            bias = stats.mean(axis=0) - truth
            var = stats.var(axis=0)
            for j in range(stats.shape[1]):
                rows.append(dict(buffer=B, N=N, param_index=j,
                                 abs_bias=float(abs(bias[j])),
                                 variance=float(var[j]),
                                 mse=float(bias[j] ** 2 + var[j])))
    df = pd.DataFrame(rows)
    os.makedirs(out_dir, exist_ok=True)
    df.to_csv(os.path.join(out_dir, f"{model_name}_grad_error.csv"),
              index=False)

    # log-scale bias-vs-buffer figure (`svm_grad_compare.py:177-214`)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 4))
    for (N, j), g in df.groupby(["N", "param_index"]):
        g = g.sort_values("buffer")
        ax.semilogy(g["buffer"], g["abs_bias"],
                    marker="o", ms=3, label=f"N={N} param{j}", alpha=0.7)
    ax.set_xlabel("buffer size")
    ax.set_ylabel("|bias|")
    ax.set_title(f"{model_name}: gradient bias vs buffer size")
    ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, f"{model_name}_grad_error.png"),
                dpi=120)
    return df


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="svm",
                    choices=["svm", "svjm", "lgssm", "garch"])
    ap.add_argument("--T", type=int, default=100)
    ap.add_argument("--L", type=int, default=16)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--truth_N", type=int, default=100000)
    ap.add_argument("--out", default="./grad_error_out")
    args = ap.parse_args()
    df = run(args.model, T=args.T, L=args.L, reps=args.reps,
             truth_N=args.truth_N, out_dir=args.out)
    summary = df.groupby("buffer")["abs_bias"].mean()
    print(json.dumps({str(k): float(v) for k, v in summary.items()}))
