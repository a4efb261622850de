"""Per-model SGLD throughput.

Same protocol as bench.py (aggregate SGLD steps/s on one device, the
fused window kernel where the platform has it), parameterized by model
family.

Usage: python scripts/bench_model.py --model svjm [--chains 2048]
"""
import argparse
import json
import pathlib
import sys
import time

import importlib.util
if importlib.util.find_spec("sgmcmc_tpu") is None:
    # repo-root fallback for uninstalled checkouts (pip install -e . removes the need)
    import pathlib, sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

from sgmcmc_tpu.inference import sgmcmc

T = 1000
SUBSEQ, BUFFER = 40, 10
ITERS = 20


def get_model_bundle(name):
    if name == "svm":
        from sgmcmc_tpu.models import svm as mod
        true = mod.from_scalars(A=0.9, Q=0.5, R=1.0)
        init = mod.from_scalars(A=0.5, Q=1.0, R=2.0)
    elif name == "svjm":
        from sgmcmc_tpu.models import svjm as mod
        true = mod.from_scalars(A=0.9, Q=0.5, R=1.0, pJ=0.1, QJ=2.0)
        init = mod.from_scalars(A=0.5, Q=1.0, R=2.0, pJ=0.2, QJ=1.0)
    elif name == "garch":
        from sgmcmc_tpu.models import garch as mod
        true = mod.from_alpha_beta_gamma(0.1, 0.4, 0.3, R=0.5)
        init = mod.from_alpha_beta_gamma(0.15, 0.3, 0.3, R=1.0)
    elif name == "lgssm":
        from sgmcmc_tpu.models import lgssm as mod
        true = mod.from_matrices(A=[[0.9]], C=[[1.0]], Q=[[0.5]], R=[[1.0]])
        init = mod.from_matrices(A=[[0.5]], C=[[1.0]], Q=[[1.0]], R=[[2.0]])
    else:
        raise ValueError(name)
    return mod, true, init


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="svjm",
                    choices=["svm", "svjm", "garch", "lgssm"])
    ap.add_argument("--chains", type=int, default=2048)
    ap.add_argument("--particles", type=int, default=1024)
    args = ap.parse_args()

    mod, true, init = get_model_bundle(args.model)
    from sgmcmc_tpu.models.registry import get_model
    api = get_model(args.model if args.model != "lgssm" else "lgssm")

    key = jax.random.PRNGKey(0)
    ys, _ = api.generate_data(jax.random.fold_in(key, 1), true, T)

    cfg = sgmcmc.PFScoreConfig(
        n_particles=args.particles, subsequence_length=SUBSEQ,
        buffer_length=BUFFER, minibatch_size=1, smoother="poyiadjis_N",
        resampler="systematic", resample_mode="auto")
    score_fn = sgmcmc.make_pf_score_fn(
        api.get_kernel(None), api.grad_statistic, api.grad_statistic_dim,
        api.unpack_grad, cfg, T, prior_mean_var_fn=api.prior_mean_var,
        fused_model=api.get_fused(None) if api.get_fused else None)
    prior = api.default_prior()
    grad_fn = sgmcmc.make_noisy_grad_fn(
        score_fn, lambda p: api.grad_logprior(prior, p), T)

    def chain_step(k, p, obs):
        new, ll = sgmcmc.sgld_step(k, p, obs, grad_fn, epsilon=0.1, T=T)
        return api.project_parameters(new), ll

    def multi_chain_iters(keys, params, obs):
        def body(p, i):
            ks = jax.vmap(lambda k: jax.random.fold_in(k, i))(keys)
            p, ll = jax.vmap(chain_step, in_axes=(0, 0, None))(ks, p, obs)
            return p, ll
        return jax.lax.scan(body, params, jnp.arange(ITERS, dtype=jnp.int32))

    fit = jax.jit(multi_chain_iters, donate_argnums=(1,))
    keys = jax.random.split(jax.random.fold_in(key, 2), args.chains)
    params0 = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (args.chains,) + x.shape).copy(), init)

    p, ll = jax.block_until_ready(fit(keys, params0, ys))
    t0 = time.perf_counter()
    p, ll = jax.block_until_ready(fit(keys, p, ys))
    dt = time.perf_counter() - t0

    steps_per_s = args.chains * ITERS / dt
    print(json.dumps({
        "model": args.model, "chains": args.chains,
        "particles": args.particles,
        "steps_per_s": steps_per_s,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind}))


if __name__ == "__main__":
    main()
