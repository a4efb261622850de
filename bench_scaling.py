"""Weak-scaling efficiency benchmark for the distributed SGLD step.

Measures aggregate SGLD steps/s of the full distributed training step
(`sgmcmc_tpu.parallel.training`) at increasing chain-device counts with a
fixed number of chains per device (weak scaling), and reports efficiency
relative to one device.

By default the script runs on a virtual 8-device CPU mesh (the standard
JAX trick) to validate the mechanism — its times are CPU times, not
device numbers.  With --backend gpu the same code measures scaling over
the host's GPUs (NVLink).

Usage: python bench_scaling.py [--backend cpu|gpu] [--devices 1 2 4 8]
Prints one JSON line per device count plus a summary line.
"""
import argparse
import json
import os
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--chains_per_device", type=int, default=4)
    ap.add_argument("--n_particles", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--T", type=int, default=256)
    ap.add_argument("--subseq", type=int, default=32)
    ap.add_argument("--buffer", type=int, default=8)
    args = ap.parse_args()

    if args.backend == "cpu":
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device_count="
                                     f"{max(args.devices)}").strip()
    import jax
    if args.backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from sgmcmc_tpu.inference import sgmcmc
    from sgmcmc_tpu.models import svm
    from sgmcmc_tpu.parallel import sharding, training

    true = svm.from_scalars(A=0.9, Q=0.5, R=1.0)
    ys, _ = svm.generate_data(jax.random.PRNGKey(0), true, args.T)
    prior = svm.default_prior()
    cfg = sgmcmc.PFScoreConfig(
        n_particles=args.n_particles, subsequence_length=args.subseq,
        buffer_length=args.buffer,
        smoother="poyiadjis_N", resampler="systematic",
        resample_mode="auto")

    results = {}
    for n_dev in args.devices:
        if n_dev > len(jax.devices()):
            continue
        mesh = sharding.make_mesh(n_chain_devices=n_dev,
                                  n_particle_devices=1,
                                  devices=jax.devices()[:n_dev])
        step = training.make_distributed_sgld_step(
            svm.KERNEL, svm.grad_statistic, svm.STATISTIC_DIM,
            svm.unpack_grad, lambda p: svm.grad_logprior(prior, p), cfg,
            args.T, mesh, epsilon=0.1, fused_model=svm.FUSED,
            prior_mean_var_fn=lambda p: (0.0, svm.stationary_variance(p)),
            project_fn=svm.project_parameters)
        fit = training.make_distributed_fit(step, args.iters)

        n_chains = args.chains_per_device * n_dev
        keys = jax.random.split(jax.random.PRNGKey(1), n_chains)
        params0 = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (n_chains,) + x.shape).copy(),
            svm.from_scalars(A=0.5, Q=1.0, R=2.0))
        keys = sharding.shard_chain_states(mesh, keys)
        params0 = sharding.shard_chain_states(mesh, params0)

        jax.block_until_ready(fit(keys, params0, ys))
        t0 = time.perf_counter()
        jax.block_until_ready(fit(keys, params0, ys))
        dt = time.perf_counter() - t0
        sps = n_chains * args.iters / dt
        results[n_dev] = sps
        print(json.dumps({"devices": n_dev, "chains": n_chains,
                          "steps_per_s": round(sps, 1)}))

    if 1 in results:
        effs = {d: round(results[d] / (results[1] * d), 3)
                for d in results}
        print(json.dumps({"metric": "weak-scaling efficiency vs 1 device",
                          "efficiency": effs,
                          "platform": jax.devices()[0].platform,
                          "device_kind": jax.devices()[0].device_kind}))


if __name__ == "__main__":
    main()
