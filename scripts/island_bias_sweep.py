"""Island-fused smoother bias vs island size (VERDICT r2 #2; SVM leg r4).

`island_fused=True` (`parallel/training.py`) runs the fused Pallas window
kernel per particle shard as P independent N/P-particle filters and
psum-averages the Fisher-identity scores.  Averaging independent islands
leaves the *expectation* equal to a single island-size filter's score, so
the island bias IS the Poyiadjis-smoother bias at N = island size
(reference estimator contract: `particle_filters/pf.py:84-136`; Vergé et
al. 2015 island PF).

Two measured curves, keyed by --model:

* ``lgssm`` — exact Kalman gradient oracle (`ops/kalman.py`), W=48.
* ``svm``   — the nonlinear model island_fused actually targets, at the
  demo window (W = S + 2B = 24); no exact gradient exists, so the oracle
  is the N=2^20 global-resampling Poyiadjis score averaged over replicate
  keys (the `artifacts/grad_error` protocol, oracle se reported).

Run on the GPU (the window kernel compiled for the card):
    python scripts/island_bias_sweep.py --model lgssm
    python scripts/island_bias_sweep.py --model svm
Add --interpret to run the kernel in the Pallas interpreter on the CPU
(same statistics, far slower).
Merges per-model results into scripts/island_bias_sweep.json and prints a
markdown table.
"""
import argparse
import json
import os
import sys
import time

import importlib.util
if importlib.util.find_spec("sgmcmc_tpu") is None:
    # repo-root fallback for uninstalled checkouts (pip install -e . removes the need)
    import pathlib, sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

JSON_PATH = os.path.join(os.path.dirname(__file__), "island_bias_sweep.json")
ISLANDS = [64, 128, 256, 512, 1024]
R = 256
INTERPRET = False     # --interpret


def sweep(fused_batch, gather_batch, exact_vec, oracle_note):
    rows = []

    def record(label, fn, M, reps=R):
        import jax
        keys = jax.random.split(jax.random.PRNGKey(12345), reps)
        t0 = time.time()
        stats, lls = fn(keys)
        stats = np.asarray(jax.device_get(stats), np.float64)
        elapsed = time.time() - t0
        mean = stats.mean(axis=0)
        se = stats.std(axis=0) / np.sqrt(reps)
        bias = mean - exact_vec
        rel = np.abs(bias) / (np.abs(exact_vec) + 1e-12)
        rows.append(dict(label=label, N=M, reps=reps,
                         bias=bias.tolist(), se=se.tolist(),
                         max_rel_bias=float(rel.max()),
                         max_abs_bias=float(np.abs(bias).max())))
        print(f"{label:28s} N={M:7d}  max|bias|={np.abs(bias).max():.4f}  "
              f"max rel={rel.max():.4f}  se~{se.max():.4f}  "
              f"[{elapsed:.1f}s]", flush=True)

    for M in ISLANDS:
        record("island (fused, per-island)", fused_batch(M), M)
    record("global resampling (gather)", gather_batch(1024, "poyiadjis_N",
                                                      1.0), 1024)
    record("nemeth lambda=0.95 (gather)", gather_batch(1024, "nemeth",
                                                       0.95), 1024)
    print(f"\noracle: {oracle_note}")
    return rows


def run_lgssm():
    import jax
    import jax.numpy as jnp

    from sgmcmc_tpu.models import lgssm
    from sgmcmc_tpu.ops.buffered import run_buffered_pf
    from sgmcmc_tpu.ops.pallas.fused_pf import fused_pf_score

    interpret = INTERPRET
    W = 48          # full window, no buffering: pure smoother bias
    params64 = lgssm.from_matrices(A=[[0.8]], C=[[1.0]], Q=[[0.5]],
                                   R=[[0.7]])
    ys64, _ = lgssm.generate_data(jax.random.PRNGKey(0), params64, W)
    exact = lgssm.gradient_marginal_loglikelihood(params64, ys64)
    exact_vec = np.concatenate([
        np.asarray(exact.LRinv_vec), np.asarray(exact.LQinv_vec),
        np.asarray(exact.C).ravel(), np.asarray(exact.A).ravel()])

    dtype = jnp.float32
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype),
                                    params64)
    ys = jnp.asarray(ys64, dtype)
    step_w = jnp.ones((W,), dtype)
    pm = jnp.zeros((), dtype)
    pv = jnp.asarray(10.0, dtype)
    fm = lgssm.get_fused(None)

    def fused_batch(M):
        def one(k):
            return fused_pf_score(fm, k, params, ys, step_w, M, pm, pv,
                                  lambduh=1.0, interpret=interpret)
        return jax.jit(jax.vmap(one))

    def gather_batch(N, smoother, lambduh=0.95):
        def one(k):
            out = run_buffered_pf(
                lgssm.get_kernel("optimal"), lgssm.grad_statistic, params,
                ys, key=k, n_particles=N,
                statistic_dim=lgssm.statistic_dim(1, 1), smoother=smoother,
                prior_mean=jnp.zeros((1,), dtype),
                prior_var=10.0 * jnp.eye(1, dtype=dtype),
                resampler="systematic", resample_mode="gather",
                lambduh=lambduh)
            return out.mean_statistic, out.loglikelihood
        return jax.jit(jax.vmap(one))

    rows = sweep(fused_batch, gather_batch, exact_vec,
                 "exact Kalman gradient")
    return dict(W=W, reps=R, exact=exact_vec.tolist(),
                coords=["LRinv", "LQinv", "C", "A"],
                oracle="exact Kalman gradient", rows=rows)


def run_svm():
    import jax
    import jax.numpy as jnp

    from sgmcmc_tpu.models import svm
    from sgmcmc_tpu.ops.buffered import run_buffered_pf
    from sgmcmc_tpu.ops.pallas.fused_pf import fused_pf_score

    interpret = INTERPRET
    W = 24          # demo window S + 2B = 16 + 2*4
    N_ORACLE = 1 << 20
    R_ORACLE = 32
    params = svm.from_scalars(A=0.9, Q=0.5, R=1.0, dtype=jnp.float32)
    ys, _ = svm.generate_data(jax.random.PRNGKey(0), params, W)
    ys = ys.astype(jnp.float32)
    step_w = jnp.ones((W,), jnp.float32)
    pm = jnp.zeros((), jnp.float32)
    pv = jnp.asarray(svm.stationary_variance(params), jnp.float32)
    fm = svm.get_fused(None)

    def gather_one(N, smoother, lambduh):
        def one(k):
            out = run_buffered_pf(
                svm.KERNEL, svm.grad_statistic, params, ys, key=k,
                n_particles=N, statistic_dim=svm.STATISTIC_DIM,
                smoother=smoother, prior_mean=pm, prior_var=pv,
                resampler="systematic", resample_mode="gather",
                lambduh=lambduh)
            return out.mean_statistic, out.loglikelihood
        return one

    # ---- oracle: N=2^20 Poyiadjis, averaged over R_ORACLE keys (one key
    # per program execution bounds the live memory to one 2^20 filter)
    print(f"oracle: poyiadjis_N at N=2^20 x {R_ORACLE} keys ...",
          flush=True)
    oracle_fn = jax.jit(gather_one(N_ORACLE, "poyiadjis_N", 1.0))
    o_stats = []
    t0 = time.time()
    for i in range(R_ORACLE):
        st, _ = oracle_fn(jax.random.PRNGKey(777 + i))
        o_stats.append(np.asarray(jax.device_get(st), np.float64))
    o_stats = np.stack(o_stats)
    exact_vec = o_stats.mean(axis=0)
    oracle_se = o_stats.std(axis=0) / np.sqrt(R_ORACLE)
    print(f"oracle mean {exact_vec} se {oracle_se} "
          f"[{time.time() - t0:.1f}s]", flush=True)

    def fused_batch(M):
        def one(k):
            return fused_pf_score(fm, k, params, ys, step_w, M, pm, pv,
                                  lambduh=1.0, interpret=interpret)
        return jax.jit(jax.vmap(one))

    def gather_batch(N, smoother, lambduh=0.95):
        return jax.jit(jax.vmap(gather_one(N, smoother, lambduh)))

    rows = sweep(fused_batch, gather_batch, exact_vec,
                 f"poyiadjis_N N=2^20 x {R_ORACLE} keys, "
                 f"se~{oracle_se.max():.4f}")
    return dict(W=W, reps=R, exact=exact_vec.tolist(),
                oracle_se=oracle_se.tolist(),
                coords=["grad_A", "grad_LQinv", "grad_LRinv"],
                oracle=f"poyiadjis_N N=2^20 x {R_ORACLE} keys", rows=rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="lgssm", choices=["lgssm", "svm"])
    ap.add_argument("--interpret", action="store_true",
                    help="run the window kernel in the Pallas interpreter "
                         "(CPU runs)")
    args = ap.parse_args()
    global INTERPRET
    INTERPRET = args.interpret

    result = run_lgssm() if args.model == "lgssm" else run_svm()

    data = {}
    if os.path.exists(JSON_PATH):
        with open(JSON_PATH) as f:
            data = json.load(f)
        if "rows" in data:            # legacy flat (lgssm-only) layout
            data = {"lgssm": data}
    data[args.model] = result
    with open(JSON_PATH, "w") as f:
        json.dump(data, f, indent=1)
    print(f"wrote {JSON_PATH} [{args.model}]")

    print(f"\n| estimator ({args.model}) | N (island) | max |bias| "
          f"| max rel bias |")
    print("|---|---|---|---|")
    for r in result["rows"]:
        print(f"| {r['label']} | {r['N']} | {r['max_abs_bias']:.4f} "
              f"| {r['max_rel_bias']:.3f} |")


if __name__ == "__main__":
    main()
