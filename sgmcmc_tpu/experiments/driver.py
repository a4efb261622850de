"""Experiment driver CLI — the L6 harness.

One model-generic rewrite of the reference's three per-model drivers
(`/root/reference/nonlinear_ssm_pf_experiment_scripts/{lgssm,svm,garch}/driver.py`),
with the same phase structure:

  --setup          generate synthetic train/test data, inits, option grid
  --make_scripts   write shell scripts for batch execution
  --fit            checkpointed SG-MCMC fit for --experiment_id
  --eval           offline evaluation (train/test/half_avg_train/half_avg_test)
  --trace_eval     trace metrics (ksd, kstest)
  --process_out    aggregate per-experiment CSVs
  --make_plots     metric-vs-time facet plots

Experiment state lives under --path:
  in/options.p, in/options.csv, in/data.p, in/init_{method}.p
  scratch/fit_<id>_state.p          (crash/resume checkpoints)
  out/fit/<id>_parameters.p         (traces)
  out/eval/<id>_{target}_metrics.csv
  processed/aggregated.csv
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from ..evaluation.evaluator import (OfflineEvaluator, SamplerEvaluator,
                                    half_average_parameters_list)
from ..inference.samplers import Sampler
from ..io import checkpoint as ckpt
from ..metrics import metric_functions as mf
from ..metrics.ksd import compute_ksd
from ..models.registry import get_model
from ..utils.runtime import enable_compile_cache
from . import config as cfg

logging.basicConfig(
    level=logging.INFO,
    format="%(levelname)s: %(asctime)s - %(name)s: %(message)s ")
logger = logging.getLogger(__name__)

KSD_VARIABLES = {
    # natural trace-eval coordinates, matching the reference drivers:
    # SVM ['phi','sigma','tau'] (`svm/driver.py:927`), GARCH
    # ['log_mu','logit_phi','logit_lambduh','tau'] (`garch/driver.py:928`),
    # LGSSM ['A','Q','R'] (`lgssm/driver.py:1043`)
    "svm": ["phi", "sigma", "tau"],
    "svjm": ["phi", "sigma", "tau", "logit_pJ", "sigmaJ"],
    "garch": ["log_mu", "logit_phi", "logit_lambduh", "tau"],
    "lgssm": ["A", "Q", "R"],
    # HMM family (beyond-reference: the reference has no HMM driver):
    # simplex rows in logit storage coordinates, state means / AR
    # matrices, per-state emission scale tau = 1/LRinv
    "gauss_hmm": ["logit_pi", "mu", "tau"],
    "arphmm": ["logit_pi", "D", "tau"],
    # SLDS (beyond-reference: the reference's slds/sampler.py is broken):
    # per-state dynamics A / latent scale sigma, shared emission tau
    "slds": ["logit_pi", "A", "sigma", "tau"],
}

HMM_MODELS = ("gauss_hmm", "arphmm")


def convert_gradient(model_name: str, params, grad):
    """Reparameterize a storage-coordinate score into the natural KSD
    coordinates (the reference's `convert_gradient`,
    `svm/driver.py:1490-1499` / `garch/driver.py` / `lgssm/driver.py:
    1633-1671`) — scalar models only, like the reference.

    Documented delta: the exact chain rule is used.  With sigma =
    1/LQinv the reference multiplies by -LQinv^{-1} where the Jacobian
    dLQinv/dsigma = -LQinv^2; with Q = LQinv^{-2} the LGSSM natural
    score is -0.5 * g_LQinv * LQinv^3.
    """
    from types import SimpleNamespace

    def scal(x):
        return float(np.ravel(np.asarray(x))[0])

    if model_name == "svm":
        LQ, LR = scal(params.LQinv_vec), scal(params.LRinv_vec)
        vals = dict(phi=np.ravel(np.asarray(params.A)),
                    sigma=np.array([1.0 / LQ]), tau=np.array([1.0 / LR]))
        grads = dict(phi=np.ravel(np.asarray(grad.A)),
                     sigma=-np.ravel(np.asarray(grad.LQinv_vec)) * LQ ** 2,
                     tau=-np.ravel(np.asarray(grad.LRinv_vec)) * LR ** 2)
    elif model_name == "svjm":
        LQ, LR = scal(params.LQinv_vec), scal(params.LRinv_vec)
        LJ = scal(params.LQJinv_vec)
        vals = dict(phi=np.ravel(np.asarray(params.A)),
                    sigma=np.array([1.0 / LQ]), tau=np.array([1.0 / LR]),
                    logit_pJ=np.ravel(np.asarray(params.logit_pJ)),
                    sigmaJ=np.array([1.0 / LJ]))
        grads = dict(phi=np.ravel(np.asarray(grad.A)),
                     sigma=-np.ravel(np.asarray(grad.LQinv_vec)) * LQ ** 2,
                     tau=-np.ravel(np.asarray(grad.LRinv_vec)) * LR ** 2,
                     logit_pJ=np.ravel(np.asarray(grad.logit_pJ)),
                     sigmaJ=-np.ravel(np.asarray(grad.LQJinv_vec)) * LJ ** 2)
    elif model_name == "garch":
        LR = scal(params.LRinv_vec)
        vals = dict(
            log_mu=np.ravel(np.asarray(params.log_mu)),
            logit_phi=np.ravel(np.asarray(params.logit_phi)),
            logit_lambduh=np.ravel(np.asarray(params.logit_lambduh)),
            tau=np.array([1.0 / LR]))
        grads = dict(
            log_mu=np.ravel(np.asarray(grad.log_mu)),
            logit_phi=np.ravel(np.asarray(grad.logit_phi)),
            logit_lambduh=np.ravel(np.asarray(grad.logit_lambduh)),
            tau=-np.ravel(np.asarray(grad.LRinv_vec)) * LR ** 2)
    elif model_name == "lgssm":
        LQ, LR = scal(params.LQinv_vec), scal(params.LRinv_vec)
        vals = dict(A=np.ravel(np.asarray(params.A)),
                    Q=np.array([LQ ** -2]), R=np.array([LR ** -2]))
        grads = dict(
            A=np.ravel(np.asarray(grad.A)),
            Q=-0.5 * np.ravel(np.asarray(grad.LQinv_vec)) * LQ ** 3,
            R=-0.5 * np.ravel(np.asarray(grad.LRinv_vec)) * LR ** 3)
    elif model_name == "slds":
        # scalar-block SLDS (n = m = 1): logit_pi / A pass through;
        # per-state sigma_k = 1/LQinv_k and tau = 1/LRinv via the exact
        # chain rule, as in the SVM converter
        LQ = np.ravel(np.asarray(params.LQinv_vec))        # [K]
        LR = np.ravel(np.asarray(params.LRinv_vec))        # [1]
        # no abs: the chain rule -g*L^2 below assumes tau = 1/L (the SVM
        # branch convention); projection keeps L positive on driver traces
        vals = dict(
            logit_pi=np.ravel(np.asarray(params.logit_pi)),
            A=np.ravel(np.asarray(params.A)),
            sigma=1.0 / LQ, tau=1.0 / LR)
        grads = dict(
            logit_pi=np.ravel(np.asarray(grad.logit_pi)),
            A=np.ravel(np.asarray(grad.A)),
            sigma=-np.ravel(np.asarray(grad.LQinv_vec)) * LQ ** 2,
            tau=-np.ravel(np.asarray(grad.LRinv_vec)) * LR ** 2)
    elif model_name in HMM_MODELS:
        # m=1 HMM family (the driver's synthetic setup): logit_pi rows and
        # the mean/AR block pass through in storage coordinates; the
        # per-state emission scale tau_k = 1/LRinv_k has d tau/dLRinv =
        # -LRinv^{-2}, so g_tau = -g_LRinv * LRinv^2 (exact chain rule)
        LR = np.ravel(np.asarray(params.LRinv_vec))
        loc_name = "mu" if model_name == "gauss_hmm" else "D"
        loc = getattr(params, loc_name)
        # no abs (the -g*L^2 chain rule below assumes tau = 1/L)
        vals = {
            "logit_pi": np.ravel(np.asarray(params.logit_pi)),
            loc_name: np.ravel(np.asarray(loc)),
            "tau": 1.0 / LR,
        }
        grads = {
            "logit_pi": np.ravel(np.asarray(grad.logit_pi)),
            loc_name: np.ravel(np.asarray(getattr(grad, loc_name))),
            "tau": -np.ravel(np.asarray(grad.LRinv_vec)) * LR ** 2,
        }
    else:
        raise ValueError(f"no natural coordinates for {model_name}")
    return SimpleNamespace(**vals), SimpleNamespace(**grads)

TRUE_PARAMS = {
    "svm": dict(A=0.9, Q=0.5, R=1.0),
    "svjm": dict(A=0.9, Q=0.5, R=1.0, pJ=0.05, QJ=2.0),
    "lgssm": dict(A=0.9, Q=0.5, R=1.0),
    "garch": dict(alpha=0.1, beta=0.4, gamma=0.3, R=0.5),
    # well-separated 2-state synthetic setups (the reference has no HMM
    # driver; these mirror its LGSSM demo scale)
    "gauss_hmm": dict(pi=[[0.9, 0.1], [0.1, 0.9]],
                      mu=[[-1.0], [1.0]],
                      R=[[[0.5]], [[0.5]]]),
    "arphmm": dict(pi=[[0.9, 0.1], [0.1, 0.9]],
                   D=[[[0.7]], [[-0.7]]],
                   R=[[[0.5]], [[0.5]]]),
    "slds": dict(pi=[[0.95, 0.05], [0.05, 0.95]],
                 A=[[[0.9]], [[-0.9]]],
                 Q=[[[0.5]], [[0.5]]], C=[[1.0]], R=[[0.5]]),
}


def _default_dtype():
    import jax
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _make_true_params(model_name: str, dtype=None):
    if dtype is None:
        dtype = _default_dtype()
    if model_name == "svm":
        from ..models import svm
        return svm.from_scalars(**TRUE_PARAMS["svm"], dtype=dtype)
    if model_name == "svjm":
        from ..models import svjm
        return svjm.from_scalars(**TRUE_PARAMS["svjm"], dtype=dtype)
    if model_name == "lgssm":
        from ..models import lgssm
        p = TRUE_PARAMS["lgssm"]
        return lgssm.from_matrices(A=[[p["A"]]], C=[[1.0]], Q=[[p["Q"]]],
                                   R=[[p["R"]]], dtype=dtype)
    if model_name == "garch":
        from ..models import garch
        return garch.from_alpha_beta_gamma(**TRUE_PARAMS["garch"],
                                           dtype=dtype)
    if model_name == "gauss_hmm":
        from ..models import gauss_hmm
        p = TRUE_PARAMS["gauss_hmm"]
        return gauss_hmm.from_values(np.array(p["pi"]), np.array(p["mu"]),
                                     np.array(p["R"]), dtype=dtype)
    if model_name == "arphmm":
        from ..models import arphmm
        p = TRUE_PARAMS["arphmm"]
        return arphmm.from_values(np.array(p["pi"]), np.array(p["D"]),
                                  np.array(p["R"]), dtype=dtype)
    if model_name == "slds":
        from ..models import slds
        p = TRUE_PARAMS["slds"]
        return slds.from_values(np.array(p["pi"]), np.array(p["A"]),
                                np.array(p["Q"]), np.array(p["C"]),
                                np.array(p["R"]), dtype=dtype)
    raise ValueError(model_name)


def _paths(root):
    return {name: os.path.join(root, name)
            for name in ["in", "scratch", "out", "processed", "scripts"]}


# --------------------------------------------------------------------------
# setup
# --------------------------------------------------------------------------

def do_setup(args, sampler_grid=None):
    """Generate train/test data, inits and the experiment-option grid
    (`svm/driver.py:184-197, 1224-1344`)."""
    p = _paths(args.path)
    for d in p.values():
        ckpt.make_path(d)
    model_name = args.model
    true_params = _make_true_params(model_name)
    model = get_model(model_name)
    key = jax.random.PRNGKey(args.seed)
    # SLDS generate_data returns (y, x, z); the others (y, x)
    out_train = model.generate_data(jax.random.fold_in(key, 0),
                                    true_params, args.T)
    out_test = model.generate_data(jax.random.fold_in(key, 1),
                                   true_params, args.T_test)
    data = dict(
        observations=np.asarray(out_train[0]),
        latent_vars=np.asarray(out_train[1]),
        test_observations=np.asarray(out_test[0]),
        test_latent_vars=np.asarray(out_test[1]),
        parameters=ckpt.tree_to_numpy(true_params),
    )
    if len(out_train) > 2:
        data["latent_z"] = np.asarray(out_train[2])
        data["test_latent_z"] = np.asarray(out_test[2])
    ckpt.save_pickle(os.path.join(p["in"], "data.p"), data)

    # inits: prior draw and truth (`setup_init`, `svm/driver.py:1299`)
    prior = model.default_prior()
    for method in args.init_methods:
        if method == "truth":
            init = true_params
        elif method == "prior":
            init = model.project_parameters(
                model.sample_prior(prior, jax.random.fold_in(key, 2)))
        else:
            raise ValueError(method)
        ckpt.save_pickle(os.path.join(p["in"], f"init_{method}.p"),
                         ckpt.tree_to_numpy(init))

    if sampler_grid is None:
        sampler_grid = default_sampler_grid(model_name)
    data_args = [dict(init_method=m) for m in args.init_methods]
    options_list = [cfg.with_defaults(o)
                    for o in cfg.dict_product(sampler_grid, data_args)]
    for i, o in enumerate(options_list):
        o["experiment_id"] = i
        o["model"] = model_name
        o["T"] = args.T
    ckpt.save_pickle(os.path.join(p["in"], "options.p"), options_list)
    ckpt.save_dataframe(os.path.join(p["in"], "options.csv"),
                        pd.DataFrame(options_list))
    logger.info("setup: %d experiments", len(options_list))
    return options_list


def default_sampler_grid(model_name):
    """Default experiment grid mirroring `demo_setup.py` variants
    (`svm/demo_setup.py:76-113`, `lgssm/demo_setup.py:76-134`)."""
    if model_name == "slds":
        # Gibbs reference + buffered complete-data SGLD (the SLDS's only
        # gradient family — reference contract, `slds/sampler.py:491-660`)
        grids = [
            dict(iter_type=["Gibbs"], name=["GIBBS"]),
            dict(iter_type=["SGLD"], epsilon=[0.05],
                 subsequence_length=[16], buffer_length=[4],
                 steps_per_iteration=[5], latent_draws=[1],
                 latent_burnin=[5], name=["SGLD_COMPLETE"]),
        ]
        out = []
        for g in grids:
            out.extend(cfg.parameter_grid(g))
        return out
    if model_name in HMM_MODELS:
        # Gibbs reference + buffered SGLD + SCIR simplex variant, mirroring
        # the Gibbs-anchored pattern of `lgssm/demo_setup.py:88-97` (the
        # reference has no HMM driver — beyond-reference reach)
        grids = [
            dict(iter_type=["Gibbs"], name=["GIBBS"]),
            dict(iter_type=["SGLD"], kind=["marginal"], epsilon=[0.1],
                 subsequence_length=[16], buffer_length=[0, 4],
                 steps_per_iteration=[10], name=["SGLD"]),
            dict(iter_type=["SCIR"], epsilon=[0.1],
                 subsequence_length=[16], buffer_length=[4],
                 steps_per_iteration=[10], name=["SCIR"]),
        ]
        out = []
        for g in grids:
            out.extend(cfg.parameter_grid(g))
        return out
    grids = [
        dict(iter_type=["SGLD"], epsilon=[0.1], subsequence_length=[40],
             buffer_length=[0, 10], steps_per_iteration=[10],
             pf=["poyiadjis_N"], N=[1000], name=["POYIADJIS_N_1000"]),
        dict(iter_type=["SGLD"], epsilon=[0.1], subsequence_length=[40],
             buffer_length=[10], steps_per_iteration=[10],
             pf=["nemeth"], N=[1000], name=["NEMETH_1000"]),
        dict(iter_type=["SGLD"], epsilon=[0.1], subsequence_length=[40],
             buffer_length=[10], steps_per_iteration=[10],
             pf=["paris"], N=[100], name=["PARIS_100"]),
    ]
    if model_name == "lgssm":
        grids.append(dict(iter_type=["Gibbs"], name=["GIBBS"]))
        grids.append(dict(iter_type=["SGLD"], kind=["marginal"],
                          epsilon=[0.1], subsequence_length=[40],
                          buffer_length=[10], steps_per_iteration=[10],
                          name=["KF"]))
    out = []
    for g in grids:
        out.extend(cfg.parameter_grid(g))
    return out


# --------------------------------------------------------------------------
# fit
# --------------------------------------------------------------------------

def _build_sampler(options, data, init_params,
                   obs_key: str = "observations") -> Sampler:
    """Model-specific sampler (Gibbs/SCIR mixins where they exist) so every
    iter_type in the model's grid is callable (`svm/driver.py:342-358`)."""
    from ..inference.samplers import sampler_for_model
    return sampler_for_model(options["model"],
                             observations=jnp.asarray(data[obs_key]),
                             seed=options.get("seed", 0),
                             parameters=init_params)


def _metric_fns(options, data, sampler):
    model_name = options["model"]
    target = data["parameters"]       # pytree dataclass with numpy leaves
    variables = KSD_VARIABLES[model_name]
    return [mf.metric_function_parameters(target, variables, "logmse")]


def do_fit_multichain(args, options):
    """Multi-chain scan-path fit: C vmapped chains through the public
    `Sampler.fit_scan(num_chains=C)` surface (one compiled program per
    chunk — the flagship-throughput path, see PERF.md), recording
    the stacked trace plus per-coordinate convergence diagnostics
    (split-R-hat / ESS / IACT; the multi-chain protocol of
    artifacts/eurus_garch_validation.md as driver output).

    Output layout:
      out/fit/<id>_parameters.p     parameters_list = chain-0 trace (so
                                    the --eval/--trace_eval phases work
                                    unchanged) + 'chain_parameters'
                                    stacked [C, n, ...] leaves
      out/fit/<id>_convergence.csv  per-coordinate rhat/ess/iact rows
    """
    from ..metrics.convergence import convergence_summary
    p = _paths(args.path)
    data = ckpt.load_pickle(os.path.join(p["in"], "data.p"))
    init = ckpt.load_pickle(
        os.path.join(p["in"], f"init_{options['init_method']}.p"))
    state_path = os.path.join(p["scratch"],
                              f"fit_{options['experiment_id']}_state.p")
    C = args.num_chains
    iter_type = options.get("iter_type", "SGLD")
    if iter_type not in ("SGLD", "SGRLD", "SGD", "ADAGRAD"):
        raise ValueError(
            f"--num_chains {C} needs a gradient iter_type "
            f"(SGLD/SGRLD/SGD/ADAGRAD), not {iter_type!r}")
    sampler = _build_sampler(options, data, init)
    # the scan carry requires params/observations dtype agreement (a
    # f32-pickled init under an x64 run would promote mid-step)
    obs_dt = sampler.observations.dtype
    sampler.parameters = jax.tree_util.tree_map(
        lambda x: x.astype(obs_dt)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
        sampler.parameters)
    if not hasattr(sampler, "fit_scan"):
        raise ValueError(
            f"--num_chains needs a fit_scan-capable sampler; "
            f"{type(sampler).__name__} (model {options['model']!r}) has "
            f"none — run it single-chain")
    step_kwargs = cfg.sampler_kwargs(options)
    eps = options.get("epsilon", 0.1)
    steps = options.get("steps_per_iteration", 1)
    max_time = args.max_time or options.get("max_time", 60)
    max_iters = options.get("max_num_iters", 10 ** 6)
    chunk = min(options.get("checkpoint_num_iters", 1000), max_iters)
    # overdispersed per-chain prior inits whenever the experiment's own
    # init is a prior draw; a truth init replicates (chains diverge via
    # their independent Langevin noise)
    chain_init = ("prior" if options.get("init_method") == "prior"
                  else "replicate")

    chunks, times, it = [], [], 0
    if os.path.exists(state_path) and not args.no_resume:
        state = ckpt.load_pickle(state_path)
        chunks, times, it = (state["chunks"], state["times"],
                             state["iteration"])
        sampler.parameters = state["parameters"]
        sampler._num_chains = state["num_chains"]
        sampler._key = state["key"]
        chain_init = "replicate"
        logger.info("resumed multichain fit %s at iteration %d",
                    options["experiment_id"], it)

    # public multi-chip path: shard each chain's PF over P devices
    # (`fit_scan(n_particle_devices=P)`, parallel/training.py)
    P = getattr(args, "num_particle_devices", 1) or 1
    mesh_kwargs = {}
    if P > 1:
        if iter_type != "SGLD":
            raise ValueError(
                f"--num_particle_devices needs iter_type SGLD "
                f"(the distributed training step), not {iter_type!r}")
        mesh_kwargs = dict(n_particle_devices=P,
                           island_fused=getattr(args, "island_fused",
                                                False))

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < max_time and it < max_iters:
        n = min(chunk, max_iters - it)
        trace = sampler.fit_scan(iter_type, num_iters=n, epsilon=eps,
                                 steps_per_iteration=steps, num_chains=C,
                                 chain_init=chain_init, **mesh_kwargs,
                                 **step_kwargs)
        chain_init = "replicate"
        chunks.append(jax.device_get(trace))
        it += n
        times.extend([time.perf_counter() - t0] * n)
        ckpt.save_pickle(state_path, dict(
            chunks=chunks, times=times, iteration=it,
            parameters=ckpt.tree_to_numpy(sampler.parameters),
            num_chains=C, key=np.asarray(sampler._key)))
    trace = jax.tree_util.tree_map(
        lambda *xs: np.concatenate(xs, axis=1), *chunks)

    rows = convergence_summary(trace, burn_frac=0.5)
    for r in rows:
        r["experiment_id"] = options["experiment_id"]
    out_dir = ckpt.make_path(os.path.join(p["out"], "fit"))
    ckpt.save_dataframe(os.path.join(
        out_dir, f"{options['experiment_id']}_convergence.csv"),
        pd.DataFrame(rows))
    # gate on the robust estimator (plain split-R-hat is noisy right at
    # the 1.1 threshold — the reason the parity gates use rhat_rank)
    worst = max(r["rhat_rank"] for r in rows)
    logger.info("multichain fit %s: %d iters x %d chains, max rhat_rank "
                "%.3f", options["experiment_id"], it, C, worst)
    if worst > 1.1:
        logger.warning("max rank-normalized split-R-hat %.3f > 1.1: "
                       "chains are not mixed at this budget (see "
                       "*_convergence.csv)", worst)

    # chain-0 list view keeps --eval/--trace_eval/--process_out working
    chain0 = [jax.tree_util.tree_map(lambda x: x[0, i], trace)
              for i in range(it)]
    parameters_list = [ckpt.tree_to_numpy(init)] + chain0
    ckpt.save_trace(os.path.join(
        out_dir, f"{options['experiment_id']}_parameters.p"),
        parameters_list, [0.0] + times,
        extra=dict(chain_parameters=trace, num_chains=C))
    sampler.select_chain(0)


def do_fit(args, options):
    """Checkpointed fit loop (`do_fit`, `svm/driver.py:329-536`)."""
    if getattr(args, "num_chains", 1) > 1:
        return do_fit_multichain(args, options)
    p = _paths(args.path)
    data = ckpt.load_pickle(os.path.join(p["in"], "data.p"))
    init = ckpt.load_pickle(
        os.path.join(p["in"], f"init_{options['init_method']}.p"))
    state_path = os.path.join(p["scratch"],
                              f"fit_{options['experiment_id']}_state.p")

    sampler = _build_sampler(options, data, init)
    evaluator = SamplerEvaluator(
        sampler, metric_functions=_metric_fns(options, data, sampler),
        sample_functions=[mf.sample_function_parameters(
            KSD_VARIABLES[options["model"]])])

    parameters_list = [sampler.parameters]
    times = [0.0]
    start_iteration = 0
    if os.path.exists(state_path) and not args.no_resume:
        state = ckpt.load_pickle(state_path)
        evaluator.load_state(state["evaluator_state"])
        parameters_list = state["parameters_list"]
        times = state["times"]
        start_iteration = state["iteration"]
        logger.info("resumed fit %s at iteration %d",
                    options["experiment_id"], start_iteration)

    iter_type = options.get("iter_type", "SGLD")
    step_kwargs = cfg.sampler_kwargs(options)
    steps = options.get("steps_per_iteration", 1)
    max_time = args.max_time or options.get("max_time", 60)
    max_iters = options.get("max_num_iters", 10 ** 6)
    checkpoint_every = options.get("checkpoint_num_iters", 1000)

    func_names, func_kwargs = _iter_funcs(iter_type, options, step_kwargs)
    # time-based metric throttling (`do_fit`, `svm/driver.py:460-474`):
    # eval_freq is SECONDS between metric/sample evaluations; parameters
    # are still recorded every iteration
    eval_freq = options.get("eval_freq", 5)
    t_start = time.perf_counter()
    last_eval = -float("inf")
    it = start_iteration

    def evaluate_now():
        nonlocal last_eval
        evaluator.eval_metric_functions(sampler, evaluator.iteration,
                                        time=evaluator.elapsed_time)
        evaluator.eval_sample_functions(sampler, evaluator.iteration,
                                        time=evaluator.elapsed_time)
        last_eval = evaluator.elapsed_time

    try:
        while (time.perf_counter() - t_start < max_time
               and it < max_iters):
            for _ in range(steps):
                evaluator.evaluate_sampler_step(func_names, func_kwargs,
                                                evaluate=False)
            # time-throttled, but forced on the final iteration (the
            # reference also forces max_num_iters-1 / max-time-exceeded,
            # `svm/driver.py:470-472`)
            if (evaluator.elapsed_time - last_eval > eval_freq
                    or it + 1 >= max_iters):
                evaluate_now()
            parameters_list.append(sampler.parameters)
            times.append(evaluator.elapsed_time)
            it += 1
            if it % checkpoint_every == 0:
                _save_fit_state(state_path, evaluator, parameters_list,
                                times, it)
        if last_eval != evaluator.elapsed_time:
            # max-time exit between scheduled evals: metrics at the
            # FINAL fitted parameters must exist
            evaluate_now()
    except Exception:
        _save_fit_state(state_path, evaluator, parameters_list, times, it)
        raise
    _save_fit_state(state_path, evaluator, parameters_list, times, it)
    out_dir = ckpt.make_path(os.path.join(p["out"], "fit"))
    ckpt.save_trace(os.path.join(
        out_dir, f"{options['experiment_id']}_parameters.p"),
        parameters_list, times)
    ckpt.save_dataframe(os.path.join(
        out_dir, f"{options['experiment_id']}_metrics.csv"),
        evaluator.get_metrics())
    if len(parameters_list) >= 9:
        # single-chain split-chain diagnostics (split-R-hat detects the
        # mid-transient failure mode of eurus_garch_validation.md even
        # without parallel chains); the [1, N, ...] stacking matches the
        # multichain CSV schema so --process_out aggregates both
        from ..metrics.convergence import convergence_summary
        stacked = jax.tree_util.tree_map(
            lambda *xs: np.stack(xs)[None], *[
                ckpt.tree_to_numpy(q) for q in parameters_list[1:]])
        rows = convergence_summary(stacked, burn_frac=0.5)
        # burn + splitting leaves very few samples on short traces —
        # flag those rows so aggregation doesn't over-trust tiny-N rhat
        low_n = len(parameters_list) - 1 < 20
        for r in rows:
            r["experiment_id"] = options["experiment_id"]
            r["low_sample"] = low_n
        ckpt.save_dataframe(os.path.join(
            out_dir, f"{options['experiment_id']}_convergence.csv"),
            pd.DataFrame(rows))
        worst = max(r["rhat_rank"] for r in rows)
        if worst > 1.1:
            logger.warning(
                "fit %s: max rank-normalized split-R-hat %.3f > 1.1 — "
                "the chain is not stationary at this budget (see "
                "*_convergence.csv)", options["experiment_id"], worst)
    logger.info("fit %s: %d iterations", options["experiment_id"], it)


def _iter_funcs(iter_type, options, step_kwargs):
    eps = options.get("epsilon", 0.1)
    if iter_type == "SGLD":
        return (["sample_sgld", "project_parameters"],
                [dict(epsilon=eps, **step_kwargs), {}])
    if iter_type == "SGRLD":
        return (["sample_sgrld", "project_parameters"],
                [dict(epsilon=eps, **step_kwargs), {}])
    if iter_type == "SGD":
        return (["step_sgd", "project_parameters"],
                [dict(epsilon=eps, **step_kwargs), {}])
    if iter_type == "ADAGRAD":
        return (["step_adagrad", "project_parameters"],
                [dict(epsilon=eps, **step_kwargs), {}])
    if iter_type == "SCIR":
        # SGLD with the exact Gamma-process simplex update
        # (`hmm_helper.py:489-524`); projection is inside the step
        return (["sample_sgld_scir"], [dict(epsilon=eps, **step_kwargs)])
    if iter_type == "Gibbs":
        return (["sample_gibbs", "project_parameters"], [{}, {}])
    raise ValueError(f"Unrecognized iter_type {iter_type}")


def _save_fit_state(path, evaluator, parameters_list, times, iteration):
    ckpt.save_pickle(path, dict(
        evaluator_state=evaluator.save_state(),
        parameters_list=[ckpt.tree_to_numpy(q) for q in parameters_list],
        times=times,
        iteration=iteration,
    ))


# --------------------------------------------------------------------------
# eval
# --------------------------------------------------------------------------

def _eval_params_list(args, trace, half_avg: bool = False,
                      burn_frac: float | None = None):
    """(parameters_list, times) for --eval/--trace_eval, honoring
    ``--eval_chains`` (VERDICT r5 #7).

    ``pooled`` consumes EVERY chain of a multi-chain trace
    (chain-major concatenation of the stacked ``chain_parameters``;
    half-averaging and burn-in apply per chain — a flat burn on the
    pooled list would discard whole chains).  ``0`` keeps the r4
    behavior: the chain-0 ``parameters_list`` view.  Single-chain traces
    are unaffected by the flag.  Extends the reference's
    `evaluator.py:187-377` offline-eval semantics to stacked traces.
    """
    params_list = trace["parameters_list"]
    times = trace.get("times")
    if times is None:
        times = list(range(len(params_list)))
    mode = getattr(args, "eval_chains", "0")
    if mode == "pooled" and trace.get("chain_parameters") is not None:
        from ..io.checkpoint import unstack_trace
        stacked = trace["chain_parameters"]       # leaves [C, n, ...]
        C = trace.get("num_chains") or \
            jax.tree_util.tree_leaves(stacked)[0].shape[0]
        # per-iteration wall times are shared across vmapped chains
        chain_times = times[1:] if len(times) else []
        pooled, pooled_times = [], []
        for c in range(C):
            lst = unstack_trace(
                jax.tree_util.tree_map(lambda x: x[c], stacked))
            if burn_frac:
                lst = lst[int(len(lst) * burn_frac):]
            if half_avg:
                lst = half_average_parameters_list(lst)
            pooled.extend(lst)
            pooled_times.extend(chain_times[-len(lst):] if chain_times
                                else range(len(lst)))
        return pooled, pooled_times
    if burn_frac:
        keep = int(len(params_list) * burn_frac)
        params_list = params_list[keep:]
        times = times[keep:]
    if half_avg:
        params_list = half_average_parameters_list(params_list)
    return params_list, times


def do_eval(args, options, target: str):
    """Offline evaluation over a saved trace (`do_eval`,
    `svm/driver.py:541-691`).  target in
    {train, test, half_avg_train, half_avg_test}."""
    p = _paths(args.path)
    data = ckpt.load_pickle(os.path.join(p["in"], "data.p"))
    trace = ckpt.load_trace(os.path.join(
        p["out"], "fit", f"{options['experiment_id']}_parameters.p"))
    params_list, times = _eval_params_list(
        args, trace, half_avg=target.startswith("half_avg"))
    obs_key = "observations" if target.endswith("train") else \
        "test_observations"
    sampler = _build_sampler(options, data, params_list[-1],
                             obs_key=obs_key)
    metric_fns = _metric_fns(options, data, sampler)
    metric_fns.append(mf.noisy_logjoint_loglike_metric(
        N=args.eval_N, subsequence_length=-1))
    if args.eval_predictive > 0:
        # held-out k-step predictive loglikelihood rows — recorded by
        # default, as the reference does unconditionally
        # (`svm/driver.py:602-603`; slot 0 = filter loglik on PF models)
        kind = "pf" if sampler.model.has_pf else "marginal"
        supported = hasattr(sampler, "predictive_loglikelihood") and (
            sampler.model.has_pf
            or sampler.model.predictive_loglikelihood is not None)
        if supported:
            pred_kwargs = dict(N=args.eval_N) if kind == "pf" else {}
            metric_fns.append(mf.noisy_predictive_logjoint_loglike_metric(
                args.eval_predictive, kind=kind, **pred_kwargs))
        else:
            logger.info("model %s has no predictive loglikelihood; "
                        "skipping the predictive metric", options["model"])
    evaluator = OfflineEvaluator(
        sampler, params_list, times, metric_functions=metric_fns)
    evaluator.evaluate(num_to_eval=args.num_to_eval)
    out_dir = ckpt.make_path(os.path.join(p["out"], "eval"))
    ckpt.save_dataframe(os.path.join(
        out_dir, f"{options['experiment_id']}_{target}_metrics.csv"),
        evaluator.get_metrics())
    logger.info("eval %s %s done", options["experiment_id"], target)


# --------------------------------------------------------------------------
# trace_eval: KSD + KS test
# --------------------------------------------------------------------------

def do_eval_ksd(args, options):
    """Per-trace-sample PF score -> IMQ-KSD (`do_eval_ksd`,
    `svm/driver.py:906-1090`)."""
    p = _paths(args.path)
    data = ckpt.load_pickle(os.path.join(p["in"], "data.p"))
    trace = ckpt.load_trace(os.path.join(
        p["out"], "fit", f"{options['experiment_id']}_parameters.p"))
    # 33% burn-in per chain (`svm/driver.py:1006`); --eval_chains pooled
    # scores every chain's post-burn samples
    params_list, _ = _eval_params_list(args, trace, burn_frac=1.0 / 3.0)
    if args.max_ksd_samples and len(params_list) > args.max_ksd_samples:
        idx = np.linspace(0, len(params_list) - 1,
                          args.max_ksd_samples).astype(int)
        params_list = [params_list[i] for i in idx]

    sampler = _build_sampler(options, data, params_list[0])
    # check_finite=False: keep the score loop's async dispatch (the
    # per-call NaN guard would force a blocking transfer per task);
    # non-finite scores surface in the KSD conversion below
    grad_kwargs = dict(N=args.ksd_N, subsequence_length=-1,
                      is_scaled=False, check_finite=False)
    if not sampler.model.has_pf:
        grad_kwargs["kind"] = "marginal"
        grad_kwargs.pop("N")

    # KSD grad state is checkpointed and resumable, mirroring the
    # reference's KSD-state protocol (`svm/driver.py:968-999, 1068-1075`):
    # accumulated scores + cursor, saved every few samples; ``ksd_passes``
    # cycles over the trace averaging away PF score noise
    # (`svm/driver.py:1006-1022`).
    passes = getattr(args, "ksd_passes", 1) or 1
    state_path = os.path.join(p["scratch"],
                              f"ksd_{options['experiment_id']}_state.p")
    n_tasks = passes * len(params_list)
    if os.path.exists(state_path):
        state = ckpt.load_pickle(state_path)
        grad_sums, cur = state["grad_sums"], state["cur_index"]
        logger.info("ksd %s: resuming at %d/%d",
                    options["experiment_id"], cur, n_tasks)
    else:
        grad_sums, cur = [None] * len(params_list), 0
    for task in range(cur, n_tasks):
        i = task % len(params_list)
        sampler.parameters = params_list[i]
        g = sampler.noisy_gradient(**grad_kwargs)
        grad_sums[i] = g if grad_sums[i] is None else jax.tree_util.tree_map(
            lambda a, b: a + b, grad_sums[i], g)
        if (task + 1) % 20 == 0:
            ckpt.save_pickle(state_path, dict(grad_sums=grad_sums,
                                              cur_index=task + 1))
    grads = [jax.tree_util.tree_map(lambda a: a / passes, g)
             for g in grad_sums]
    if os.path.exists(state_path):
        os.remove(state_path)
    variables = KSD_VARIABLES[options["model"]]
    # reparameterize (theta, score) pairs into the natural trace-eval
    # coordinates (`convert_gradient`, `svm/driver.py:1014-1049`)
    nat = [convert_gradient(options["model"], q, g)
           for q, g in zip(params_list, grads)]
    ksd = compute_ksd([v for v, _ in nat], [g for _, g in nat], variables,
                      max_block_size=512)
    rows = [dict(metric="ksd", variable=v, value=val,
                 experiment_id=options["experiment_id"])
            for v, val in ksd.items()]
    out_dir = ckpt.make_path(os.path.join(p["out"], "trace_eval"))
    ckpt.save_dataframe(os.path.join(
        out_dir, f"{options['experiment_id']}_ksd.csv"), pd.DataFrame(rows))
    logger.info("ksd %s: %s", options["experiment_id"], ksd)


def do_eval_ks_test(args, options, all_options):
    """KS two-sample test of each scalar parameter's trace against a Gibbs
    reference trace (`do_eval_ks_test`, `svm/driver.py:1093-1218`)."""
    from ..metrics.ks_test import ks_test_traces
    p = _paths(args.path)
    gibbs = [o for o in all_options if o.get("iter_type") == "Gibbs"]
    if not gibbs:
        logger.warning("no Gibbs reference run for KS test")
        return
    ref_trace = ckpt.load_trace(os.path.join(
        p["out"], "fit", f"{gibbs[0]['experiment_id']}_parameters.p"))
    trace = ckpt.load_trace(os.path.join(
        p["out"], "fit", f"{options['experiment_id']}_parameters.p"))
    variables = KSD_VARIABLES[options["model"]]
    rows = ks_test_traces(trace["parameters_list"],
                          ref_trace["parameters_list"], variables)
    for r in rows:
        r["experiment_id"] = options["experiment_id"]
    out_dir = ckpt.make_path(os.path.join(p["out"], "trace_eval"))
    ckpt.save_dataframe(os.path.join(
        out_dir, f"{options['experiment_id']}_kstest.csv"),
        pd.DataFrame(rows))


# --------------------------------------------------------------------------
# process_out / make_plots
# --------------------------------------------------------------------------

def do_process_out(args, options_list):
    """Aggregate per-experiment CSVs joined with options
    (`do_process_out`, `svm/driver.py:696-822`)."""
    p = _paths(args.path)
    opts_df = pd.DataFrame(options_list)
    frames = []
    for sub in ["fit", "eval", "trace_eval"]:
        d = os.path.join(p["out"], sub)
        if not os.path.isdir(d):
            continue
        for fname in sorted(os.listdir(d)):
            if not fname.endswith(".csv"):
                continue
            df = pd.read_csv(os.path.join(d, fname))
            df["source"] = f"{sub}/{fname}"
            if "experiment_id" not in df.columns:
                df["experiment_id"] = int(fname.split("_")[0])
            frames.append(df)
    if not frames:
        logger.warning("nothing to aggregate")
        return None
    agg = pd.concat(frames, ignore_index=True)
    agg = agg.merge(opts_df, on="experiment_id", how="left",
                    suffixes=("", "_option"))
    ckpt.save_dataframe(os.path.join(p["processed"], "aggregated.csv"), agg)
    logger.info("aggregated %d rows", len(agg))
    return agg


def do_make_plots(args, options_list):
    """Metric-vs-time facet plots (`do_make_plots`,
    `svm/driver.py:826-901`)."""
    from ..evaluation import plotting
    p = _paths(args.path)
    agg_path = os.path.join(p["processed"], "aggregated.csv")
    if not os.path.exists(agg_path):
        do_process_out(args, options_list)
    agg = pd.read_csv(agg_path)
    fig_dir = ckpt.make_path(os.path.join(p["processed"], "figures"))
    plotting.plot_aggregated_metrics(agg, fig_dir)


def do_make_scripts(args, options_list):
    """Generate fit/eval/... shell scripts (`svm/driver.py:202-324`)."""
    from .script_builder import chain_scripts, script_builder
    p = _paths(args.path)
    driver = os.path.abspath(__file__)
    common = dict(path=args.path, model=args.model)
    all_scripts = []
    for phase, extra in [
            ("fit", dict(fit=True)),
            ("eval_train", dict(eval="half_avg_train")),
            ("eval_test", dict(eval="half_avg_test")),
            ("trace_eval", dict(trace_eval="ksd")),
    ]:
        arg_dicts = [dict(common, experiment_id=o["experiment_id"], **extra)
                     for o in options_list]
        all_scripts += script_builder(
            phase, driver, arg_dicts, p["scripts"],
            script_splits=args.script_splits)
    all_scripts += script_builder(
        "process_out", driver, [dict(common, process_out=True)],
        p["scripts"])
    chain_scripts("run_all", all_scripts, p["scripts"])
    logger.info("wrote %d scripts", len(all_scripts))


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

def build_parser():
    parser = argparse.ArgumentParser(
        description="sgmcmc_tpu experiment driver",
        fromfile_prefix_chars="@")
    parser.add_argument("--path", default="./experiment")
    parser.add_argument("--model", default="svm",
                        choices=["svm", "svjm", "lgssm", "garch",
                                 "gauss_hmm", "arphmm", "slds"])
    parser.add_argument("--experiment_id", type=int, default=-1)
    parser.add_argument("--setup", action="store_true")
    parser.add_argument("--make_scripts", action="store_true")
    parser.add_argument("--fit", action="store_true")
    parser.add_argument("--eval", type=str, default=None,
                        choices=[None, "train", "test", "half_avg_train",
                                 "half_avg_test"])
    parser.add_argument("--trace_eval", type=str, default=None,
                        choices=[None, "ksd", "kstest"])
    parser.add_argument("--process_out", action="store_true")
    parser.add_argument("--make_plots", action="store_true")
    parser.add_argument("--T", type=int, default=1000)
    parser.add_argument("--T_test", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--init_methods", nargs="+",
                        default=["prior", "truth"])
    parser.add_argument("--max_time", type=float, default=None)
    parser.add_argument("--num_chains", type=int, default=1,
                        help="run C vmapped chains through "
                             "fit_scan(num_chains=C) in --fit, recording "
                             "the stacked trace + split-R-hat/ESS "
                             "convergence rows (1 = reference-style "
                             "single-chain loop)")
    parser.add_argument("--num_particle_devices", type=int, default=1,
                        help="shard each chain's particle filter over P "
                             "mesh devices in --fit (the "
                             "fit_scan(n_particle_devices=P) public "
                             "multi-chip path; SGLD + PF models only)")
    parser.add_argument("--island_fused", action="store_true",
                        help="with --num_particle_devices > 1: per-device "
                             "fused-kernel island particle filters with "
                             "psum-averaged scores (keep >= 256 particles "
                             "per device, see parallel/training.py)")
    parser.add_argument("--eval_chains", type=str, default="0",
                        choices=["0", "pooled"],
                        help="--eval/--trace_eval on a multi-chain trace: "
                             "'pooled' scores every chain's samples "
                             "(per-chain burn/half-averaging), '0' the "
                             "chain-0 view (r4 behavior)")
    parser.add_argument("--num_to_eval", type=int, default=20)
    parser.add_argument("--eval_N", type=int, default=1000)
    parser.add_argument("--eval_predictive", type=int, default=5,
                        help="k-step held-out predictive-loglikelihood "
                             "metric rows in --eval; the reference "
                             "records num_steps_ahead=5 unconditionally "
                             "(svm/driver.py:602-603) so the default is "
                             "on; 0 disables")
    parser.add_argument("--ksd_N", type=int, default=1000)
    parser.add_argument("--max_ksd_samples", type=int, default=100)
    parser.add_argument("--ksd_passes", type=int, default=1,
                        help="cycling passes over the trace, averaging "
                             "the PF score noise (svm/driver.py:1006)")
    parser.add_argument("--script_splits", type=int, default=1)
    parser.add_argument("--no_resume", action="store_true")
    return parser


def _selected(options_list, experiment_id):
    if experiment_id == -1:
        return options_list
    return [o for o in options_list
            if o["experiment_id"] == experiment_id]


def main(argv=None):
    args = build_parser().parse_args(argv)
    enable_compile_cache()
    p = _paths(args.path)
    if args.setup:
        do_setup(args)
    options_list = None
    opts_path = os.path.join(p["in"], "options.p")
    if os.path.exists(opts_path):
        options_list = ckpt.load_pickle(opts_path)
    needs_options = (args.make_scripts or args.fit or args.eval
                     or args.trace_eval or args.process_out
                     or args.make_plots)
    if needs_options and options_list is None:
        raise SystemExit(
            f"No experiment options at {opts_path}; run --setup first "
            f"(or pass the correct --path).")
    if args.make_scripts:
        do_make_scripts(args, options_list)
    if args.fit:
        for o in _selected(options_list, args.experiment_id):
            do_fit(args, o)
    if args.eval:
        for o in _selected(options_list, args.experiment_id):
            do_eval(args, o, args.eval)
    if args.trace_eval == "ksd":
        for o in _selected(options_list, args.experiment_id):
            do_eval_ksd(args, o)
    elif args.trace_eval == "kstest":
        for o in _selected(options_list, args.experiment_id):
            do_eval_ks_test(args, o, options_list)
    if args.process_out:
        do_process_out(args, options_list)
    if args.make_plots:
        do_make_plots(args, options_list)


if __name__ == "__main__":
    main()
