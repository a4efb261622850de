"""Exact-family head-to-head parity vs the reference NumPy package
(VERDICT r4 item 5): LGSSM (conjugate Gibbs + marginal SGLD), GaussHMM
(Gibbs + SGLD), ARPHMM (Gibbs + SGLD), SLDS (blocked Gibbs).

These models have tractable message passing on both sides, so the
posterior z-scores are sharp (no particle noise).  Everything runs on
the CPU backend (the reference is NumPy; ours compiles the whole Gibbs
step / SGLD chain with XLA): same data, same default priors, independent
RNGs; state-indexed coordinates are label-aligned per draw by sorting on
the state location (mu / D / A) so HMM label switching cannot fake a
disagreement.

Usage: python artifacts/exact_parity.py [--legs lgssm_gibbs ...]
       [--gibbs_iters 3000] [--sgld_iters 30000] [--ref_seconds 600]
Writes artifacts/exact_parity.md
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")   # these legs are
jax.config.update("jax_enable_x64", True)   # exact-oracle CPU math

import numpy as np  # noqa: E402

from parity_common import compare_table  # noqa: E402

T = 400
SEED = 0


# --------------------------------------------------------------------------
# label-aligned coordinate readers (ours / reference), per model
# --------------------------------------------------------------------------

def read_ours_lgssm(p):
    lq = float(np.abs(np.ravel(np.asarray(p.LQinv_vec))[0]))
    lr = float(np.abs(np.ravel(np.asarray(p.LRinv_vec))[0]))
    return dict(A=float(np.asarray(p.A)[0, 0]), Q=lq ** -2, R=lr ** -2)


def read_ref_lgssm(q):
    return dict(A=float(q.A[0, 0]), Q=float(q.Q[0, 0]), R=float(q.R[0, 0]))


def _hmm_coords(pi, loc, tau, loc_name):
    order = np.argsort(loc)
    out = {}
    for i, j in enumerate(order):
        out[f"{loc_name}{i}"] = float(loc[j])
        out[f"pi{i}{i}"] = float(pi[j, j])
        out[f"tau{i}"] = float(tau[j])
    return out


def read_ours_gauss_hmm(p):
    pi = np.asarray(jax.nn.softmax(np.asarray(p.logit_pi), axis=-1))
    mu = np.ravel(np.asarray(p.mu))
    tau = 1.0 / np.abs(np.ravel(np.asarray(p.LRinv_vec)))
    return _hmm_coords(pi, mu, tau, "mu")


def read_ref_gauss_hmm(q):
    mu = np.ravel(np.asarray(q.mu))
    tau = np.sqrt(np.asarray(q.R)[:, 0, 0])    # 1/LRinv = sqrt(R), m=1
    return _hmm_coords(np.asarray(q.pi), mu, tau, "mu")


def read_ours_arphmm(p):
    pi = np.asarray(jax.nn.softmax(np.asarray(p.logit_pi), axis=-1))
    D = np.asarray(p.D)[:, 0, 0]
    tau = 1.0 / np.abs(np.ravel(np.asarray(p.LRinv_vec)))
    return _hmm_coords(pi, D, tau, "D")


def read_ref_arphmm(q):
    D = np.asarray(q.D)[:, 0, 0]
    tau = np.sqrt(np.asarray(q.R)[:, 0, 0])
    return _hmm_coords(np.asarray(q.pi), D, tau, "D")


def read_ours_slds(p):
    pi = np.asarray(jax.nn.softmax(np.asarray(p.logit_pi), axis=-1))
    A = np.asarray(p.A)[:, 0, 0]
    sigma = 1.0 / np.abs(np.asarray(p.LQinv_vec)[:, 0])
    tau = float(1.0 / np.abs(np.ravel(np.asarray(p.LRinv_vec))[0]))
    order = np.argsort(A)
    out = {}
    for i, j in enumerate(order):
        out[f"A{i}"] = float(A[j])
        out[f"pi{i}{i}"] = float(pi[j, j])
        out[f"sigma{i}"] = float(sigma[j])
    out["tau"] = tau
    return out


def read_ref_slds(q):
    A = np.asarray(q.A)[:, 0, 0]
    sigma = np.sqrt(np.asarray(q.Q)[:, 0, 0])
    tau = float(np.sqrt(np.asarray(q.R)[0, 0]))
    order = np.argsort(A)
    out = {}
    for i, j in enumerate(order):
        out[f"A{i}"] = float(A[j])
        out[f"pi{i}{i}"] = float(np.asarray(q.pi)[j, j])
        out[f"sigma{i}"] = float(sigma[j])
    out["tau"] = tau
    return out


# --------------------------------------------------------------------------
# generic chain loops
# --------------------------------------------------------------------------

def collect(rows_list):
    names = rows_list[0].keys()
    burn = len(rows_list) // 2
    return {k: np.array([r[k] for r in rows_list[burn:]]) for k in names}


def ours_loop(sampler, reader, n_iters, step):
    rows = []
    t0 = time.time()
    for _ in range(n_iters):
        step(sampler)
        rows.append(reader(sampler.parameters))
    out = collect(rows)
    out.update(steps=n_iters, seconds=time.time() - t0)
    return out


def ref_loop(sampler, reader, step, n_iters=None, seconds=None):
    rows = []
    t0 = time.time()
    n = 0
    while ((n_iters is not None and n < n_iters)
           or (seconds is not None and time.time() - t0 < seconds)):
        step(sampler)
        rows.append(reader(sampler.parameters))
        n += 1
    out = collect(rows)
    out.update(steps=n, seconds=time.time() - t0)
    return out


def ours_fit_scan(sampler, reader, n_iters, n_chains=1, **kw):
    """Whole-loop-compiled marginal SGLD; read coordinates off the trace.

    ``n_chains > 1`` runs C vmapped chains (public fit_scan surface) and
    returns chain-structured [C, n_post] coordinate arrays — the
    single-chain split-R-hat is noisy right around the 1.1 gate, true
    multi-chain R-hat is not.  Chain 0 starts at the leg's init, chains
    1..C-1 at overdispersed prior draws (`prior_chain_draws`), so the
    gate sees distinct basins rather than only RNG dispersion."""
    from sgmcmc_tpu.io.checkpoint import unstack_trace
    t0 = time.time()
    if n_chains == 1:
        trace = sampler.fit_scan("SGLD", num_iters=n_iters, **kw)
        rows = [reader(p) for p in unstack_trace(jax.device_get(trace))]
        out = collect(rows)
        out.update(steps=n_iters, seconds=time.time() - t0)
        return out
    trace = sampler.fit_scan("SGLD", num_iters=n_iters,
                             num_chains=n_chains,
                             chain_init=sampler.prior_chain_draws(n_chains),
                             **kw)
    host = jax.device_get(trace)
    per_chain = []
    for c in range(n_chains):
        sub = jax.tree_util.tree_map(lambda x: x[c], host)
        per_chain.append(collect([reader(p) for p in unstack_trace(sub)]))
    out = {k: np.stack([pc[k] for pc in per_chain])
           for k in per_chain[0] if k not in ("steps", "seconds")}
    out.update(steps=n_iters * n_chains, seconds=time.time() - t0)
    return out


# --------------------------------------------------------------------------
# data + legs
# --------------------------------------------------------------------------

def make_data(model):
    key = jax.random.PRNGKey(SEED)
    if model == "lgssm":
        from sgmcmc_tpu.models import lgssm
        true = lgssm.from_matrices(A=[[0.9]], C=[[1.0]], Q=[[0.5]],
                                   R=[[1.0]])
        ys, _ = lgssm.generate_data(key, true, T)
        truth = dict(A=0.9, Q=0.5, R=1.0)
        return np.asarray(ys), truth, true
    if model == "gauss_hmm":
        from sgmcmc_tpu.models import gauss_hmm
        true = gauss_hmm.from_values([[0.9, 0.1], [0.1, 0.9]],
                                     [[-1.0], [1.0]],
                                     [[[0.5]], [[0.5]]])
        ys, _ = gauss_hmm.generate_data(key, true, T)
        truth = dict(mu0=-1.0, mu1=1.0, pi00=0.9, pi11=0.9,
                     tau0=0.5 ** 0.5, tau1=0.5 ** 0.5)
        return np.asarray(ys), truth, true
    if model == "arphmm":
        from sgmcmc_tpu.models import arphmm
        true = arphmm.from_values([[0.9, 0.1], [0.1, 0.9]],
                                  [[[-0.7]], [[0.7]]],
                                  [[[0.5]], [[0.5]]])
        ys, _ = arphmm.generate_data(key, true, T)
        truth = dict(D0=-0.7, D1=0.7, pi00=0.9, pi11=0.9,
                     tau0=0.5 ** 0.5, tau1=0.5 ** 0.5)
        return np.asarray(ys), truth, true
    if model == "slds":
        from sgmcmc_tpu.models import slds
        true = slds.from_values([[0.95, 0.05], [0.05, 0.95]],
                                [[[0.9]], [[-0.9]]],
                                [[[0.5]], [[0.5]]], [[1.0]], [[0.5]])
        ys = slds.generate_data(key, true, T)[0]
        truth = dict(A0=-0.9, A1=0.9, pi00=0.95, pi11=0.95,
                     sigma0=0.5 ** 0.5, sigma1=0.5 ** 0.5,
                     tau=0.5 ** 0.5)
        return np.asarray(ys), truth, true
    raise ValueError(model)



def ref_init(model):
    """Reference Parameters at the same truth init the ours side uses
    (storage-coordinate constructors; LRinv = chol(inv(R)))."""
    if model == "lgssm":
        from sgmcmc_ssm.models.lgssm import LGSSMParameters
        return LGSSMParameters(
            A=np.array([[0.9]]), C=np.array([[1.0]]),
            LQinv=np.array([[0.5 ** -0.5]]), LRinv=np.array([[1.0]]))
    logit_pi9 = np.log(np.array([[0.9, 0.1], [0.1, 0.9]]))
    LRinv_states = np.full((2, 1, 1), 0.5 ** -0.5)
    if model == "gauss_hmm":
        from sgmcmc_ssm.models.gauss_hmm import GaussHMMParameters
        return GaussHMMParameters(
            logit_pi=logit_pi9, mu=np.array([[-1.0], [1.0]]),
            LRinv=LRinv_states)
    if model == "arphmm":
        from sgmcmc_ssm.models.arphmm import ARPHMMParameters
        return ARPHMMParameters(
            logit_pi=logit_pi9, D=np.array([[[-0.7]], [[0.7]]]),
            LRinv=LRinv_states)
    if model == "slds":
        from sgmcmc_ssm.models.slds import SLDSParameters
        return SLDSParameters(
            logit_pi=np.log(np.array([[0.95, 0.05], [0.05, 0.95]])),
            A=np.array([[[0.9]], [[-0.9]]]), LQinv=LRinv_states,
            C=np.array([[1.0]]), LRinv=np.array([[0.5 ** -0.5]]))
    raise ValueError(model)


def leg_lgssm_gibbs(args):
    from sgmcmc_tpu.inference.samplers import LGSSMSampler
    ys, truth, true_p = make_data("lgssm")
    s = LGSSMSampler(observations=ys, seed=1)
    s.parameters = true_p
    ours = ours_loop(s, read_ours_lgssm, args.gibbs_iters,
                     lambda sm: (sm.sample_gibbs(), sm.project_parameters()))
    sys.path.insert(0, "/root/reference")
    np.random.seed(2)
    from sgmcmc_ssm.models.lgssm import LGSSMSampler as RefSampler
    r = RefSampler(n=1, m=1, observations=np.asarray(ys, np.float64))
    r.parameters = ref_init("lgssm")
    ref = ref_loop(r, read_ref_lgssm,
                   lambda sm: (sm.sample_gibbs(), sm.project_parameters()),
                   n_iters=args.gibbs_iters)
    return compare_table(
        f"LGSSM conjugate Gibbs (T={T}; ours gibbs_step vs "
        f"`lgssm/sampler.py:79-96`)", ["A", "Q", "R"], ours, ref, truth)


def leg_lgssm_sgld(args):
    from sgmcmc_tpu.inference.samplers import LGSSMSampler
    ys, truth, true_p = make_data("lgssm")
    s = LGSSMSampler(observations=ys, seed=1)
    s.parameters = true_p
    ours = ours_fit_scan(s, read_ours_lgssm, args.sgld_iters,
                         epsilon=args.eps, kind="marginal",
                         subsequence_length=16, buffer_length=4)
    sys.path.insert(0, "/root/reference")
    np.random.seed(2)
    from sgmcmc_ssm.models.lgssm import LGSSMSampler as RefSampler
    r = RefSampler(n=1, m=1, observations=np.asarray(ys, np.float64))
    r.parameters = ref_init("lgssm")
    kw = dict(kind="marginal", subsequence_length=16, buffer_length=4,
              epsilon=args.eps)
    ref = ref_loop(r, read_ref_lgssm,
                   lambda sm: (sm.sample_sgld(**kw),
                               sm.project_parameters()),
                   seconds=args.ref_seconds)
    return compare_table(
        f"LGSSM buffered marginal SGLD (T={T}; eps={args.eps} S=16 B=4; "
        f"Kalman messages both sides)", ["A", "Q", "R"], ours, ref, truth)


def _hmm_leg(args, model, iter_kind):
    from sgmcmc_tpu.inference.samplers import (ARPHMMSampler,
                                               GaussHMMSampler)
    ys, truth, true_p = make_data(model)
    names = sorted(truth.keys())
    if model == "gauss_hmm":
        s = GaussHMMSampler(observations=ys, num_states=2, m=1, seed=1)
        reader, ref_reader = read_ours_gauss_hmm, read_ref_gauss_hmm
    else:
        s = ARPHMMSampler(observations=ys, num_states=2, m=1, p=1, seed=1)
        reader, ref_reader = read_ours_arphmm, read_ref_arphmm
    s.parameters = true_p
    if iter_kind == "gibbs":
        ours = ours_loop(s, reader, args.gibbs_iters,
                         lambda sm: (sm.sample_gibbs(),
                                     sm.project_parameters()))
    else:
        ours = ours_fit_scan(s, reader, args.sgld_iters, epsilon=args.eps,
                             n_chains=args.ours_chains,
                             kind="marginal", subsequence_length=16,
                             buffer_length=4)
    sys.path.insert(0, "/root/reference")

    def make_ref(seed):
        np.random.seed(seed)
        if model == "gauss_hmm":
            from sgmcmc_ssm.models.gauss_hmm import \
                GaussHMMSampler as RefSampler
            r = RefSampler(num_states=2, m=1,
                           observations=np.asarray(ys, np.float64))
        else:
            from sgmcmc_ssm.models.arphmm import \
                ARPHMMSampler as RefSampler
            r = RefSampler(num_states=2, m=1, p=1,
                           observations=np.asarray(ys, np.float64))
        r.parameters = ref_init(model)
        return r

    if iter_kind == "gibbs":
        ref = ref_loop(make_ref(2), ref_reader,
                       lambda sm: (sm.sample_gibbs(),
                                   sm.project_parameters()),
                       n_iters=args.gibbs_iters)
        how = ("conjugate Gibbs", "`{0}/sampler.py` sample_gibbs")
    else:
        kw = dict(subsequence_length=16, buffer_length=4, epsilon=args.eps)
        # independent reference chains sequentially (each gets the full
        # --ref_seconds); chain-structured [C, n] arrays -> true
        # multi-chain R-hat instead of noisy single-chain splits
        refs = [ref_loop(make_ref(2 + 31 * c), ref_reader,
                         lambda sm: (sm.sample_sgld(**kw),
                                     sm.project_parameters()),
                         seconds=args.ref_seconds)
                for c in range(args.ref_chains)]
        if args.ref_chains == 1:
            ref = refs[0]
        else:
            n = min(r_[names[0]].shape[0] for r_ in refs)
            ref = {k: np.stack([r_[k][-n:] for r_ in refs])
                   for k in names}
            ref.update(steps=sum(r_["steps"] for r_ in refs),
                       seconds=sum(r_["seconds"] for r_ in refs))
        how = ("buffered marginal SGLD", "discrete messages both sides")
    return compare_table(
        f"{model} {how[0]} (T={T}; state-sorted coordinates)", names,
        ours, ref, truth)


def leg_slds_gibbs(args):
    from sgmcmc_tpu.inference.samplers import SLDSSampler
    ys, truth, true_p = make_data("slds")
    names = sorted(truth.keys())
    s = SLDSSampler(observations=ys, num_states=2, n=1, m=1, seed=1)
    s.parameters = true_p
    ours = ours_loop(s, read_ours_slds, args.gibbs_iters,
                     lambda sm: (sm.sample_gibbs(),
                                 sm.project_parameters()))
    sys.path.insert(0, "/root/reference")
    np.random.seed(2)
    try:
        from sgmcmc_ssm.models.slds import SLDSSampler as RefSampler
        r = RefSampler(num_states=2, n=1, m=1,
                       observations=np.asarray(ys, np.float64))
        r.parameters = ref_init("slds")
        # `sample_gibbs` reads self.x/self.z, which only
        # `init_sample_latent` creates ('copy' init for n <= m)
        r.init_sample_latent()
        ref = ref_loop(r, read_ref_slds,
                       lambda sm: (sm.sample_gibbs(),
                                   sm.project_parameters()),
                       n_iters=args.gibbs_iters)
    except Exception as e:       # noqa: BLE001 - recorded, not hidden
        lines = [f"## SLDS blocked Gibbs (T={T})", "",
                 f"Reference leg NOT RUNNABLE: `sgmcmc_ssm.models.slds` "
                 f"fails with `{type(e).__name__}: {e}` (the reference's "
                 f"SLDS sampler is broken — SURVEY.md §2.2; ours is "
                 f"validated against its own conjugate Gibbs in "
                 f"tests/test_slds.py instead).", ""]
        return lines, dict(max_z=0.0, se=0.0, max_rhat=1.0, mixed=True,
                           passed=True, skipped=True)
    return compare_table(
        f"SLDS blocked Gibbs (T={T}; state-sorted coordinates; ours "
        f"gibbs_step vs `slds/sampler.py`)", names, ours, ref, truth)


LEGS = {
    "lgssm_gibbs": leg_lgssm_gibbs,
    "lgssm_sgld": leg_lgssm_sgld,
    "gauss_hmm_gibbs": lambda a: _hmm_leg(a, "gauss_hmm", "gibbs"),
    "gauss_hmm_sgld": lambda a: _hmm_leg(a, "gauss_hmm", "sgld"),
    "arphmm_gibbs": lambda a: _hmm_leg(a, "arphmm", "gibbs"),
    "arphmm_sgld": lambda a: _hmm_leg(a, "arphmm", "sgld"),
    "slds_gibbs": leg_slds_gibbs,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--legs", nargs="+", default=sorted(LEGS))
    ap.add_argument("--gibbs_iters", type=int, default=3000)
    ap.add_argument("--sgld_iters", type=int, default=30000)
    ap.add_argument("--ours_chains", type=int, default=1,
                    help="SGLD legs: vmapped ours chains (fit_scan "
                         "num_chains) for true multi-chain R-hat")
    ap.add_argument("--ref_chains", type=int, default=1,
                    help="SGLD legs: sequential independent reference "
                         "chains, each given --ref_seconds")
    ap.add_argument("--eps", type=float, default=0.05)
    ap.add_argument("--ref_seconds", type=float, default=600.0)
    ap.add_argument("--out", default="exact_parity.md")
    args = ap.parse_args()

    lines = ["# Exact-family posterior parity: sgmcmc_tpu vs reference "
             "NumPy", "",
             "Same data, same default priors, independent RNGs; "
             "post-burn-in (last half) posterior moments; z = "
             "|Δmean| / pooled sd ± ESS-based se; legs with "
             "split-R-hat > 1.1 are refused a PASS.", ""]
    verdicts = {}
    for leg in args.legs:
        print(f"=== {leg}", flush=True)
        sec, v = LEGS[leg](args)
        lines += sec
        verdicts[leg] = v
        print("\n".join(sec), flush=True)
    worst = max(v["max_z"] for v in verdicts.values())
    all_pass = all(v["passed"] for v in verdicts.values())
    lines += [f"**Overall: max z across legs = {worst:.2f}; "
              f"{'ALL PASS' if all_pass else 'NOT ALL PASSED'}.**  "
              + ", ".join(
                  f"{k}: z={v['max_z']:.2f}+-{v['se']:.2f}"
                  + (" (ref broken, skipped)" if v.get("skipped") else "")
                  for k, v in verdicts.items())]
    out = "\n".join(lines)
    with open(os.path.join(os.path.dirname(__file__), args.out), "w") as f:
        f.write(out + "\n")
    print(out)


if __name__ == "__main__":
    main()
