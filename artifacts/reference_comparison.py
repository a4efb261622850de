"""Posterior-moment comparison: this framework vs the reference NumPy
implementation — the north-star acceptance criterion's own protocol.

Three head-to-head legs, each running the same SGLD configuration from the
same initialization through both implementations and comparing post-burn-in
posterior means / sds in the natural trace-eval coordinates:

  * synthetic SVM  (phi, sigma, tau); eps=0.1, S=40, B=10, Poyiadjis-O(N)
  * synthetic GARCH (log_mu, logit_phi, logit_lambduh, tau); same config
  * EUR/US exchange-rate segment-1 SVM + GARCH legs at the reference demo
    protocol (`save_svm_params.py:60-91`: eps=1e-3, S=16, B=4,
    Poyiadjis-O(N)) at reduced budget

The two chains use different RNGs, so agreement is expected within
Monte-Carlo error of the posterior spread (max |Δmean| / pooled sd < 1).

Usage: python artifacts/reference_comparison.py [--ours_steps 20000]
       [--ref_seconds 600] [--legs svm garch eurus] [--ours_chains 1]
Defaults reproduce the recorded PASS tables (total wall ~3.5 h, dominated
by the two 90-min reference demo legs).  Writes
artifacts/reference_comparison.md
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def _stacked_init(sampler, fixed_init, n_chains, seed):
    """[C, ...] init: chain 0 at the leg's fixed init (the reference
    chain's exact starting point), chains 1..C-1 overdispersed prior
    draws so the multi-chain split-R-hat gate sees distinct basins.

    Uses the public `Sampler.prior_chain_draws` helper (CPU-backed prior
    draws; no sampler state mutated)."""
    return sampler.prior_chain_draws(n_chains, first=fixed_init)


def _ours_fit(sampler, steps, n_chains, **fit_kw):
    """Single-chain ([steps, ...]) or pooled multi-chain
    ([C, steps, ...]) trace through the public fit_scan surface."""
    if n_chains <= 1:
        return sampler.fit_scan("SGLD", num_iters=steps, **fit_kw)
    init = _stacked_init(sampler, sampler.parameters, n_chains, seed=7)
    return sampler.fit_scan_chunked(
        "SGLD", num_iters=steps, chunk_iters=5000,
        num_chains=n_chains, chain_init=init, **fit_kw)


def _coord(trace, n_chains, reader):
    """Post-burn-in coordinate array: [n_post] or chain-structured
    [C, n_post] (so the comparator computes multi-chain R-hat)."""
    arr = np.asarray(trace)
    out = reader(arr) if reader else arr
    n = out.shape[-1]
    return out[..., n // 2:]


def run_ours(observations, steps, seed=1, n_chains=1):
    import jax
    from sgmcmc_tpu.inference.samplers import SVMSampler
    from sgmcmc_tpu.models import svm

    s = SVMSampler(observations=observations, seed=seed)
    s.parameters = svm.from_scalars(A=0.5, Q=1.0, R=2.0)
    t0 = time.time()
    trace = _ours_fit(s, steps, n_chains, epsilon=0.1, N=1000,
                      subsequence_length=40, buffer_length=10,
                      pf="poyiadjis_N", resampler="systematic",
                      resample_mode="auto")
    elapsed = time.time() - t0
    A = _coord(trace.A, n_chains, lambda a: a[..., 0, 0])
    lq = _coord(trace.LQinv_vec, n_chains, lambda a: np.abs(a[..., 0]))
    lr = _coord(trace.LRinv_vec, n_chains, lambda a: np.abs(a[..., 0]))
    return dict(phi=A, sigma=1.0 / lq, tau=1.0 / lr,
                steps=steps * n_chains, seconds=elapsed)


def _pool_ref_chains(one_chain_fn, observations, seconds, seed, n_chains,
                     max_workers=2):
    """Pool n_chains independent reference chains (ProcessPoolExecutor —
    the reference is single-threaded NumPy) into chain-structured [C, n]
    arrays truncated to the shortest chain, so the comparator computes a
    true multi-chain split-R-hat on the reference side too."""
    if n_chains <= 1:
        return one_chain_fn(observations, seconds, seed=seed)
    from concurrent.futures import ProcessPoolExecutor
    t0 = time.time()
    with ProcessPoolExecutor(max_workers=max_workers) as ex:
        outs = list(ex.map(one_chain_fn, [observations] * n_chains,
                           [seconds] * n_chains,
                           [seed + 17 * c for c in range(n_chains)]))
    n = min(o["steps"] - o["steps"] // 2 for o in outs)  # post-burn length
    pooled = {k: np.stack([o[k][-n:] for o in outs])
              for k in outs[0] if k not in ("steps", "seconds")}
    pooled.update(steps=sum(o["steps"] for o in outs),
                  seconds=time.time() - t0)
    return pooled


def run_reference(observations, seconds, seed=2):
    sys.path.insert(0, "/root/reference")
    import numpy as np
    np.random.seed(seed)
    from sgmcmc_ssm.models.svm import SVMParameters, SVMPrior, SVMSampler

    sampler = SVMSampler(n=1, m=1, observations=np.asarray(observations))
    sampler.prior = SVMPrior.generate_default_prior(n=1, m=1)
    sampler.parameters = SVMParameters(
        A=np.array([[0.5]]), LQinv=np.array([[1.0]]),
        LRinv=np.array([[2.0 ** -0.5]]))
    kw = dict(kind="pf", pf="poyiadjis_N", N=1000, subsequence_length=40,
              buffer_length=10, epsilon=0.1)
    phis, sigmas, taus = [], [], []
    t0 = time.time()
    n = 0
    while time.time() - t0 < seconds:
        sampler.sample_sgld(**kw)
        sampler.project_parameters()
        phis.append(float(sampler.parameters.A[0, 0]))
        sigmas.append(float(abs(sampler.parameters.sigma)))
        taus.append(float(abs(sampler.parameters.tau)))
        n += 1
    burn = n // 2
    return dict(phi=np.array(phis[burn:]), sigma=np.array(sigmas[burn:]),
                tau=np.array(taus[burn:]), steps=n,
                seconds=time.time() - t0)


def run_ours_garch(observations, steps, seed=1, epsilon=0.1, S=40, B=10,
                   N=1000, n_chains=1):
    import jax
    from sgmcmc_tpu.inference.samplers import GARCHSampler
    from sgmcmc_tpu.models import garch

    s = GARCHSampler(observations=observations, seed=seed)
    s.parameters = garch.from_alpha_beta_gamma(alpha=0.2, beta=0.2,
                                               gamma=0.2, R=1.0)
    t0 = time.time()
    trace = _ours_fit(s, steps, n_chains, epsilon=epsilon, N=N,
                      subsequence_length=S, buffer_length=B,
                      pf="poyiadjis_N", resampler="systematic",
                      resample_mode="auto")
    elapsed = time.time() - t0
    lr = _coord(trace.LRinv_vec, n_chains, lambda a: np.abs(a[..., 0]))
    return dict(
        log_mu=_coord(trace.log_mu, n_chains, lambda a: a[..., 0]),
        logit_phi=_coord(trace.logit_phi, n_chains, lambda a: a[..., 0]),
        logit_lambduh=_coord(trace.logit_lambduh, n_chains,
                             lambda a: a[..., 0]),
        tau=1.0 / lr, steps=steps * n_chains, seconds=elapsed)


def run_reference_garch(observations, seconds, seed=2, epsilon=0.1, S=40,
                        B=10, N=1000):
    sys.path.insert(0, "/root/reference")
    np.random.seed(seed)
    from sgmcmc_ssm.models.garch import (GARCHParameters, GARCHPrior,
                                         GARCHSampler)

    sampler = GARCHSampler(n=1, m=1, observations=np.asarray(observations))
    sampler.prior = GARCHPrior.generate_default_prior(n=1, m=1)
    lm, lp, ll = GARCHParameters.convert_alpha_beta_gamma(0.2, 0.2, 0.2)
    sampler.parameters = GARCHParameters(
        log_mu=np.atleast_1d(lm), logit_phi=np.atleast_1d(lp),
        logit_lambduh=np.atleast_1d(ll), LRinv=np.array([[1.0]]))
    kw = dict(kind="pf", pf="poyiadjis_N", N=N, subsequence_length=S,
              buffer_length=B, epsilon=epsilon)
    rows = dict(log_mu=[], logit_phi=[], logit_lambduh=[], tau=[])
    t0 = time.time()
    n = 0
    while time.time() - t0 < seconds:
        sampler.sample_sgld(**kw)
        sampler.project_parameters()
        q = sampler.parameters
        rows["log_mu"].append(float(np.ravel(q.log_mu)[0]))
        rows["logit_phi"].append(float(np.ravel(q.logit_phi)[0]))
        rows["logit_lambduh"].append(float(np.ravel(q.logit_lambduh)[0]))
        rows["tau"].append(float(abs(np.ravel(q.tau)[0])))
        n += 1
    burn = n // 2
    out = {k: np.array(v[burn:]) for k, v in rows.items()}
    out.update(steps=n, seconds=time.time() - t0)
    return out


def run_ours_eurus_multichain(observations, model, steps, n_chains,
                              seed=1, N=1000):
    """Pooled posterior from many independent prior-initialized SGLD
    chains at the reference demo protocol, through the PUBLIC
    `Sampler.fit_scan_chunked(num_chains=...)` surface (r4: previously
    hand-wired vmap plumbing).  Pooling across chains controls the
    Monte-Carlo error of the posterior mean (across-chain se ~
    sd/sqrt(n_chains)) where a single eps=1e-3 chain's integrated
    autocorrelation time is of order its length — see
    artifacts/eurus_garch_validation.md.  Chain-structured [C, n] arrays
    are returned so the comparator computes multi-chain R-hat/ESS."""
    import jax
    import jax.numpy as jnp
    from sgmcmc_tpu.inference.samplers import GARCHSampler, SVMSampler

    m_name = model
    cls = SVMSampler if model == "svm" else GARCHSampler
    obs = jnp.asarray(observations, jnp.float32)
    s = cls(observations=obs, seed=seed)
    prior, mdl = s.prior, s.model
    # explicit stacked prior inits so the reference leg can start from
    # chain 0's exact initialization
    p0s = jax.jit(jax.vmap(lambda k: mdl.project_parameters(
        mdl.sample_prior(prior, k))))(
        jax.random.split(jax.random.PRNGKey(seed + 1), n_chains))
    p0s = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), p0s)
    s.parameters = jax.tree_util.tree_map(lambda x: x[0], p0s)

    thin = 10          # pooled moments don't need every autocorrelated step
    t0 = time.time()
    # chunked executions: one program per 10k steps bounds the on-device
    # trace and gives a progress point per chunk
    trace = s.fit_scan_chunked(
        "SGLD", num_iters=steps, chunk_iters=10000, epsilon=0.001,
        num_chains=n_chains, chain_init=p0s, record=thin,
        N=N, subsequence_length=16, buffer_length=4, pf="poyiadjis_N",
        resampler="systematic", resample_mode="auto")
    burn = (steps // thin) // 2

    def chains(name):          # [C, n_post] chain-structured coordinates
        return np.asarray(getattr(trace, name))[:, burn:, 0]

    if m_name == "svm":
        out = dict(
            phi=np.asarray(trace.A)[:, burn:, 0, 0],
            sigma=1.0 / np.abs(chains("LQinv_vec")),
            tau=1.0 / np.abs(chains("LRinv_vec")))
    else:
        out = dict(log_mu=chains("log_mu"),
                   logit_phi=chains("logit_phi"),
                   logit_lambduh=chains("logit_lambduh"),
                   tau=1.0 / np.abs(chains("LRinv_vec")))
    init0 = jax.tree_util.tree_map(lambda x: np.asarray(x[0]), p0s)
    out.update(steps=n_chains * steps, seconds=time.time() - t0,
               init=init0)
    return out


def run_ours_eurus(observations, model, steps, seed=1, N=1000):
    """Segment leg at the reference demo protocol
    (`save_svm_params.py:60-91`): eps=1e-3, S=16, B=4, Poyiadjis O(N)."""
    import jax
    from sgmcmc_tpu.inference.samplers import GARCHSampler, SVMSampler

    if model == "svm":
        s = SVMSampler(observations=observations, seed=seed)
    else:
        s = GARCHSampler(observations=observations, seed=seed)
    s.project_parameters()
    p0 = s.parameters
    t0 = time.time()
    # chunked whole-loop-compiled executions (bounded on-device trace).
    # Keep the STACKED per-chunk trace leaves and concatenate — no
    # per-iteration Python objects.
    import jax
    chunk = 50000
    traces, done = [], 0
    while done < steps:
        n = min(chunk, steps - done)
        tr = s.fit_scan("SGLD", num_iters=n, epsilon=0.001, N=N,
                        subsequence_length=16, buffer_length=4,
                        pf="poyiadjis_N", resampler="systematic",
                        resample_mode="auto")
        traces.append(jax.device_get(tr))
        done += n
    trace = jax.tree_util.tree_map(
        lambda *xs: np.concatenate(xs, axis=0), *traces)
    elapsed = time.time() - t0
    burn = steps // 2
    if model == "svm":
        out = dict(phi=np.asarray(trace.A)[burn:, 0, 0],
                   sigma=1.0 / np.abs(np.asarray(
                       trace.LQinv_vec)[burn:, 0]),
                   tau=1.0 / np.abs(np.asarray(
                       trace.LRinv_vec)[burn:, 0]))
    else:
        out = dict(log_mu=np.asarray(trace.log_mu)[burn:, 0],
                   logit_phi=np.asarray(trace.logit_phi)[burn:, 0],
                   logit_lambduh=np.asarray(
                       trace.logit_lambduh)[burn:, 0],
                   tau=1.0 / np.abs(np.asarray(
                       trace.LRinv_vec)[burn:, 0]))
    out.update(steps=steps, seconds=elapsed, init=p0)
    return out


def run_reference_eurus(observations, model, seconds, init, seed=2, N=1000):
    sys.path.insert(0, "/root/reference")
    np.random.seed(seed)
    obs = np.asarray(observations)
    kw = dict(kind="pf", pf="poyiadjis_N", N=N, subsequence_length=16,
              buffer_length=4, epsilon=0.001)
    if model == "svm":
        from sgmcmc_ssm.models.svm import SVMParameters, SVMPrior, SVMSampler
        sampler = SVMSampler(n=1, m=1, observations=obs)
        sampler.prior = SVMPrior.generate_default_prior(n=1, m=1)
        sampler.parameters = SVMParameters(
            A=np.asarray(init.A, np.float64),
            LQinv=np.atleast_2d(np.asarray(init.LQinv_vec, np.float64)),
            LRinv=np.atleast_2d(np.asarray(init.LRinv_vec, np.float64)))
        names = ["phi", "sigma", "tau"]

        def read(q):
            return dict(phi=float(q.A[0, 0]), sigma=float(abs(q.sigma)),
                        tau=float(abs(q.tau)))
    else:
        from sgmcmc_ssm.models.garch import (GARCHParameters, GARCHPrior,
                                             GARCHSampler)
        sampler = GARCHSampler(n=1, m=1, observations=obs)
        sampler.prior = GARCHPrior.generate_default_prior(n=1, m=1)
        sampler.parameters = GARCHParameters(
            log_mu=np.asarray(init.log_mu, np.float64),
            logit_phi=np.asarray(init.logit_phi, np.float64),
            logit_lambduh=np.asarray(init.logit_lambduh, np.float64),
            LRinv=np.atleast_2d(np.asarray(init.LRinv_vec, np.float64)))
        names = ["log_mu", "logit_phi", "logit_lambduh", "tau"]

        def read(q):
            return dict(log_mu=float(np.ravel(q.log_mu)[0]),
                        logit_phi=float(np.ravel(q.logit_phi)[0]),
                        logit_lambduh=float(np.ravel(q.logit_lambduh)[0]),
                        tau=float(abs(np.ravel(q.tau)[0])))

    rows = {k: [] for k in names}
    t0 = time.time()
    n = 0
    while time.time() - t0 < seconds:
        sampler.sample_sgld(**kw)
        sampler.project_parameters()
        vals = read(sampler.parameters)
        for k in names:
            rows[k].append(vals[k])
        n += 1
    burn = n // 2
    out = {k: np.array(v[burn:]) for k, v in rows.items()}
    out.update(steps=n, seconds=time.time() - t0)
    return out


# z +- se(z) with ESS error bars, and R-hat gating (a leg with unmixed
# chains on either side is refused a PASS) — shared with exact_parity.py
from parity_common import compare_table  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ours_steps", type=int, default=20000)
    ap.add_argument("--ref_seconds", type=float, default=600.0)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--legs", nargs="+",
                    default=["svm", "garch", "eurus"])
    ap.add_argument("--eurus_segment", type=int, default=1)
    ap.add_argument("--eurus_N", type=int, default=1000)
    ap.add_argument("--eurus_ours_steps", type=int, default=400000,
                    help="the eps=1e-3 demo legs have integrated "
                         "autocorrelation times of order 1e4-1e5 steps; "
                         "shorter runs compare transients, not "
                         "posteriors (the reference budget is 8 h)")
    ap.add_argument("--eurus_ref_seconds", type=float, default=5400.0,
                    help="90 min per reference demo leg (~300k steps) — "
                         "the measured convergence budget; the recorded "
                         "PASS tables used exactly these defaults")
    ap.add_argument("--out", default="reference_comparison.md",
                    help="output markdown filename (relative to artifacts/)")
    ap.add_argument("--ours_chains", type=int, default=1,
                    help="pool this many independent vmapped SGLD chains "
                         "on the ours side (synthetic legs: chain 0 at "
                         "the fixed init, rest overdispersed prior draws; "
                         "posterior-mean MC error ~ sd/sqrt(chains); "
                         "single reference-style chain when 1)")
    ap.add_argument("--ref_chains", type=int, default=1,
                    help="synthetic legs: pool this many independent "
                         "reference chains (2 worker processes), each "
                         "given --ref_seconds — enables a true multi-"
                         "chain split-R-hat gate on the reference side")
    args = ap.parse_args()

    import jax
    lines = ["# Posterior comparison: sgmcmc_tpu vs reference NumPy",
             "",
             "Same data, same SGLD configuration, same initialization, "
             "independent RNGs; post-burn-in (last half) posterior moments "
             "in natural coordinates.  Agreement criterion: "
             "max |Δmean| / pooled posterior sd < 1.", ""]
    zs = {}

    if "svm" in args.legs:
        from sgmcmc_tpu.models import svm
        true = svm.from_scalars(A=0.9, Q=0.5, R=1.0)
        ys, _ = svm.generate_data(jax.random.PRNGKey(0), true, args.T)
        ours = run_ours(ys, args.ours_steps, n_chains=args.ours_chains)
        ref = _pool_ref_chains(run_reference, np.asarray(ys, np.float64),
                               args.ref_seconds, 2, args.ref_chains)
        sec, z = compare_table(
            f"Synthetic SVM (T={args.T}; eps=0.1 S=40 B=10 "
            f"Poyiadjis-O(N) N=1000)", ["phi", "sigma", "tau"], ours, ref,
            truth=dict(phi=0.9, sigma=0.5 ** 0.5, tau=1.0))
        lines += sec
        zs["svm"] = z

    if "garch" in args.legs:
        from sgmcmc_tpu.models import garch
        true_g = garch.from_alpha_beta_gamma(alpha=0.1, beta=0.4,
                                             gamma=0.3, R=0.5)
        ys_g, _ = garch.generate_data(jax.random.PRNGKey(1), true_g, args.T)
        ours = run_ours_garch(ys_g, args.ours_steps,
                              n_chains=args.ours_chains)
        ref = _pool_ref_chains(run_reference_garch,
                               np.asarray(ys_g, np.float64),
                               args.ref_seconds, 2, args.ref_chains)
        truth_g = dict(
            log_mu=float(np.log(0.1 / (1 - 0.7))),
            logit_phi=float(np.log(0.7 / 0.3)),
            logit_lambduh=float(np.log((0.4 / 0.7) / (0.3 / 0.7))),
            tau=float(0.5 ** 0.5))
        sec, z = compare_table(
            f"Synthetic GARCH (T={args.T}; alpha=0.1 beta=0.4 gamma=0.3 "
            f"R=0.5; eps=0.1 S=40 B=10 Poyiadjis-O(N) N=1000)",
            ["log_mu", "logit_phi", "logit_lambduh", "tau"], ours, ref,
            truth=truth_g)
        lines += sec
        zs["garch"] = z

    eurus_models = [m for m in ["svm", "garch"]
                    if "eurus" in args.legs or f"eurus_{m}" in args.legs]
    if eurus_models:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "demo", "exchange_rate"))
        from exchange_rate_demo import DEFAULT_DATA, load_segments
        segments = load_segments(DEFAULT_DATA, min_len=25)
        obs = segments[args.eurus_segment]
        e_steps = args.eurus_ours_steps
        e_ref = args.eurus_ref_seconds
        for model in eurus_models:
            if args.ours_chains > 1:
                ours = run_ours_eurus_multichain(
                    obs, model, e_steps, args.ours_chains,
                    N=args.eurus_N)
            else:
                ours = run_ours_eurus(obs, model, e_steps, N=args.eurus_N)
            ref = run_reference_eurus(np.asarray(obs, np.float64), model,
                                      e_ref, ours["init"],
                                      N=args.eurus_N)
            names = (["phi", "sigma", "tau"] if model == "svm" else
                     ["log_mu", "logit_phi", "logit_lambduh", "tau"])
            sec, z = compare_table(
                f"EUR/US segment {args.eurus_segment} "
                f"(T={obs.shape[0]}), {model.upper()} leg "
                f"(`save_{model}_params.py:60-91` protocol: eps=1e-3 "
                f"S=16 B=4 Poyiadjis-O(N) N={args.eurus_N})",
                names, ours, ref)
            lines += sec
            zs[f"eurus_{model}"] = z

    if not zs:
        raise SystemExit(f"no legs ran — unknown --legs {args.legs!r}? "
                         f"(choose from: svm, garch, eurus, eurus_svm, "
                         f"eurus_garch)")
    if any(np.isnan(v["max_z"]) for v in zs.values()):
        raise SystemExit(
            f"nan z-scores {zs} — a reference leg completed too few steps "
            f"within its budget; raise --ref_seconds")
    worst = max(v["max_z"] for v in zs.values())
    all_pass = all(v["passed"] for v in zs.values())
    lines += [f"**Overall: max |Δmean|/pooled-sd across all legs = "
              f"{worst:.2f}** ({'PASS' if all_pass else 'NOT PASSED'} at "
              f"the <1 north-star criterion with split-R-hat <= 1.1 "
              f"mixing gates).  Legs: "
              + ", ".join(f"{k}: z={v['max_z']:.2f}+-{v['se']:.2f} "
                          f"rhat={v['max_rhat']:.2f} "
                          f"{'PASS' if v['passed'] else 'no'}"
                          for k, v in zs.items()) + "."]
    out = "\n".join(lines)
    print(out)
    with open(os.path.join(os.path.dirname(__file__), args.out), "w") as f:
        f.write(out + "\n")


if __name__ == "__main__":
    main()
