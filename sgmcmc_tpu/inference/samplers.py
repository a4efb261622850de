"""User-facing sampler classes mirroring the reference API.

The reference's `SGMCMCSampler` (`sgmcmc_sampler.py:12-1155`) is a stateful
object with `fit` / `sample_sgld` / `noisy_gradient` / ... methods.  This
module provides the same ergonomics on top of the functional core: a
`Sampler` holds (model, observations, prior, parameters, PRNG key), builds
and caches jitted update functions per configuration, and mutates only its
own Python-side references.  All numerics happen in jitted pytree code.
"""
from __future__ import annotations

import time
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..models.registry import ModelAPI, get_model
from . import sgmcmc


def _draw_prior_on_cpu(sample_prior, project, prior, key):
    """Draw initial parameters eagerly on the local CPU backend.

    Priors are tiny: eager gamma/Wishart draws on the in-process CPU
    backend skip an accelerator compile of the samplers, then one
    transfer moves the result to the default device.
    """
    try:
        cpu = jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return jax.jit(lambda k: project(sample_prior(prior, k)))(key)
    with jax.default_device(cpu):
        params = project(sample_prior(prior, jax.device_put(key, cpu)))
    return jax.device_put(params, jax.devices()[0])


class Sampler:
    """Stateful convenience wrapper over the functional SG-MCMC core.

    Equivalent surface to the reference's per-model `*Sampler` classes
    (e.g. `svm/sampler.py`, `lgssm/sampler.py`).
    """

    def __init__(self, model: ModelAPI | str, observations=None, prior=None,
                 parameters=None, seed: int = 0, **options):
        self.model = get_model(model) if isinstance(model, str) else model
        self.observations = None if observations is None else jnp.asarray(
            observations)
        self.prior = self.model.default_prior() if prior is None else prior
        self.options = options
        self._key = jax.random.PRNGKey(seed)
        self._cache: dict[Any, Any] = {}
        self._num_chains: int | None = None
        if parameters is not None:
            self.parameters = parameters
        else:
            self.parameters = _draw_prior_on_cpu(
                self.model.sample_prior, self.model.project_parameters,
                self.prior, self.next_key())

    # -- PRNG threading ---------------------------------------------------
    def next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    @property
    def T(self) -> int:
        return int(self.observations.shape[0])

    # -- config / jit cache ----------------------------------------------
    # options of an earlier fused kernel, removed with it
    _REMOVED_OPTIONS = ("rng", "qp_merge", "pipeline", "interleave", "gather")

    def _score_config(self, **kwargs) -> sgmcmc.PFScoreConfig:
        removed = sorted(set(kwargs) & set(self._REMOVED_OPTIONS))
        if removed:
            raise ValueError(f"options {removed} were removed with the "
                             f"kernel they configured")
        return sgmcmc.PFScoreConfig(
            n_particles=kwargs.get("N", kwargs.get("n_particles", 1000)),
            subsequence_length=kwargs.get("subsequence_length", -1),
            buffer_length=kwargs.get("buffer_length", 0),
            minibatch_size=kwargs.get("minibatch_size", 1),
            smoother=kwargs.get("pf", kwargs.get("smoother", "poyiadjis_N")),
            resampler=kwargs.get("resampler", "multinomial"),
            resample_mode=kwargs.get("resample_mode", "auto"),
            lambduh=kwargs.get("lambduh", 0.95),
            n_tilde=kwargs.get("Ntilde", kwargs.get("n_tilde", 2)),
            partition_style=kwargs.get("partition_style", "uniform"),
            ess_threshold=kwargs.get("ess_threshold", None),
            bw_chunk=kwargs.get("bw_chunk", None),
        )

    def _default_kind(self) -> str:
        return "pf" if self.model.has_pf else "marginal"

    def _grad_fn(self, preconditioned: bool = False, is_scaled: bool = True,
                 kind: str | None = None, **kwargs):
        m = self.model
        if kind is None:
            kind = self._default_kind()
        cfg = self._score_config(**kwargs)
        kernel_name = kwargs.get("kernel")
        cache_key = ("grad", kind, cfg, kernel_name, preconditioned,
                     is_scaled, self.T, kwargs.get("num_samples", 1))
        if cache_key not in self._cache:
            if kind == "marginal":
                if m.windowed_marginal_gradient is None:
                    raise NotImplementedError(
                        f"{m.name} has no analytic message passing")
                S = cfg.subsequence_length
                full = (S == -1) or (S >= self.T)
                B = 0 if full else (self.T if cfg.buffer_length == -1
                                    else max(cfg.buffer_length, 0))
                S_eff = self.T if full else S
                score = sgmcmc.make_marginal_score_fn(
                    lambda p, w, v, wt: m.windowed_marginal_gradient(
                        p, w, v, wt, B, S_eff), cfg, self.T)
            elif kind == "complete":
                if m.windowed_complete_gradient is None:
                    raise NotImplementedError(
                        f"{m.name} has no complete-data gradient path")
                S = cfg.subsequence_length
                full = (S == -1) or (S >= self.T)
                B = 0 if full else (self.T if cfg.buffer_length == -1
                                    else max(cfg.buffer_length, 0))
                S_eff = self.T if full else S
                num_samples = kwargs.get("num_samples", 1)
                wcg = m.windowed_complete_gradient
                score = sgmcmc.make_marginal_score_fn(
                    lambda k, p, w, v, wt:
                    wcg(p, w, v, wt, B, S_eff, k, num_samples),
                    cfg, self.T, pass_key=True)
            elif kind == "pf":
                fused = m.get_fused(kernel_name) if m.get_fused else None
                score = sgmcmc.make_pf_score_fn(
                    m.get_kernel(kernel_name), m.grad_statistic,
                    m.grad_statistic_dim, m.unpack_grad, cfg, self.T,
                    prior_mean_var_fn=m.prior_mean_var,
                    fused_model=fused)
            else:
                raise ValueError(f"Unrecognized kind = '{kind}'")
            precond = None
            if preconditioned:
                if m.precondition is None:
                    raise NotImplementedError(
                        f"{m.name} has no preconditioner")
                precond = sgmcmc.Preconditioner(
                    m.precondition, m.precondition_noise, m.correction_term)
            fn = sgmcmc.make_noisy_grad_fn(
                score, lambda p: m.grad_logprior(self.prior, p), self.T,
                is_scaled=is_scaled, preconditioner=precond)
            self._cache[cache_key] = jax.jit(fn)
        return self._cache[cache_key]

    def _loglik_fn(self, **kwargs):
        cfg = self._score_config(**kwargs)
        kernel_name = kwargs.get("kernel")
        cache_key = ("loglik", cfg, kernel_name, self.T)
        if cache_key not in self._cache:
            m = self.model
            score = sgmcmc.make_pf_score_fn(
                m.get_kernel(kernel_name), m.suff_statistic,
                m.suff_statistic_dim, lambda s: s, cfg, self.T,
                prior_mean_var_fn=m.prior_mean_var)
            self._cache[cache_key] = jax.jit(score)
        return self._cache[cache_key]

    # -- likelihoods -------------------------------------------------------
    @staticmethod
    def _check_finite_ll(ll: float) -> float:
        # reference sanity guard (`sgmcmc_sampler.py:242-243`)
        import math
        if math.isnan(ll):
            raise ValueError("NaNs in loglikelihood")
        return ll

    def noisy_loglikelihood(self, kind: str | None = None, **kwargs) -> float:
        if kind is None:
            kind = self._default_kind()
        if kind == "marginal":
            if kwargs.get("subsequence_length", -1) == -1:
                return self.exact_loglikelihood()
            _, loglik = self._grad_fn(kind="marginal", **kwargs)(
                self.next_key(), self.parameters, self.observations)
            return self._check_finite_ll(float(loglik))
        if kind == "complete":
            # FFBS-draw complete-data loglikelihood over the window
            # (`noisy_loglikelihood` kind='complete',
            # `sgmcmc_sampler.py:175-210`)
            _, loglik = self._grad_fn(kind="complete", **kwargs)(
                self.next_key(), self.parameters, self.observations)
            return self._check_finite_ll(float(loglik))
        _, loglik = self._loglik_fn(**kwargs)(
            self.next_key(), self.parameters, self.observations)
        return self._check_finite_ll(float(loglik))

    def noisy_logjoint(self, return_loglike=False, **kwargs):
        ll = self.noisy_loglikelihood(**kwargs)
        lp = float(self.model.logprior(self.prior, self.parameters))
        if return_loglike:
            return dict(logjoint=ll + lp, loglikelihood=ll)
        return ll + lp

    def exact_loglikelihood(self) -> float:
        if not self.model.has_exact:
            raise NotImplementedError(
                f"{self.model.name} has no exact marginal likelihood")
        if "exact_ll" not in self._cache:
            self._cache["exact_ll"] = jax.jit(self.model.marginal_loglikelihood)
        return float(self._cache["exact_ll"](self.parameters,
                                             self.observations))

    def exact_gradient(self):
        if not self.model.has_exact:
            raise NotImplementedError
        if "exact_grad" not in self._cache:
            self._cache["exact_grad"] = jax.jit(
                self.model.gradient_marginal_loglikelihood)
        return self._cache["exact_grad"](self.parameters, self.observations)

    # -- gradient / steps --------------------------------------------------
    def _grad_has_nan(self, grad) -> bool:
        """One jitted fused reduction + one scalar transfer (instead of
        one eager isnan and transfer per leaf)."""
        if "_nan_check" not in self._cache:
            def any_nan(g):
                flags = [jnp.any(jnp.isnan(leaf))
                         for leaf in jax.tree_util.tree_leaves(g)]
                return jnp.any(jnp.stack(flags))

            self._cache["_nan_check"] = jax.jit(any_nan)
        return bool(self._cache["_nan_check"](grad))

    def noisy_gradient(self, preconditioner=False, is_scaled=True,
                       check_finite: bool = True, **kwargs):
        grad, _ = self._grad_fn(preconditioned=bool(preconditioner),
                                is_scaled=is_scaled, **kwargs)(
            self.next_key(), self.parameters, self.observations)
        # reference sanity guard (`_noisy_grad_loglikelihood`,
        # `sgmcmc_sampler.py:420-424`).  ``check_finite=False`` skips the
        # blocking transfer for batch pipelines that want async dispatch
        # (e.g. the KSD score loop); the jitted `_step` hot path never
        # pays it.
        if check_finite and self._grad_has_nan(grad):
            raise ValueError("NaNs in gradient")
        return grad

    def _step(self, name: str, epsilon: float, **kwargs):
        cache_key = ("step", name, float(epsilon),
                     tuple(sorted(kwargs.items(), key=lambda kv: kv[0]))
                     if all(isinstance(v, (int, float, str, bool, type(None)))
                            for v in kwargs.values()) else None)
        if cache_key not in self._cache or cache_key[-1] is None:
            grad_fn = self._grad_fn(
                preconditioned=(name == "sgrld"), **kwargs)
            m = self.model
            T = self.T

            if name in ("sgld", "sgrld"):
                if name == "sgrld":
                    precond = sgmcmc.Preconditioner(
                        m.precondition, m.precondition_noise,
                        m.correction_term)

                    def step(key, params, obs):
                        return sgmcmc.sgrld_step(key, params, obs, grad_fn,
                                                 precond, epsilon, T)
                else:
                    def step(key, params, obs):
                        return sgmcmc.sgld_step(key, params, obs, grad_fn,
                                                epsilon, T)
            elif name == "sgd":
                def step(key, params, obs):
                    return sgmcmc.sgd_step(key, params, obs, grad_fn, epsilon)
            else:
                raise ValueError(name)

            def step_and_project(key, params, obs):
                new, aux = step(key, params, obs)
                return m.project_parameters(new, **self.options.get(
                    "project_kwargs", {})), aux

            self._cache[cache_key] = jax.jit(step_and_project)
        return self._cache[cache_key]

    def sample_sgld(self, epsilon, **kwargs):
        self.parameters, _ = self._step("sgld", epsilon, **kwargs)(
            self.next_key(), self.parameters, self.observations)
        return self.parameters

    def sample_sgrld(self, epsilon, **kwargs):
        self.parameters, _ = self._step("sgrld", epsilon, **kwargs)(
            self.next_key(), self.parameters, self.observations)
        return self.parameters

    def step_sgd(self, epsilon, **kwargs):
        self.parameters, _ = self._step("sgd", epsilon, **kwargs)(
            self.next_key(), self.parameters, self.observations)
        return self.parameters

    def step_precondition_sgd(self, epsilon, **kwargs):
        """Preconditioned SGD (MAP ascent in the Riemannian metric;
        `step_precondition_sgd`, `sgmcmc_sampler.py:486-502`)."""
        m = self.model
        if m.precondition is None:
            raise NotImplementedError(f"{m.name} has no preconditioner")
        cache_key = ("psgd_step", float(epsilon),
                     tuple(sorted(kwargs.items())))
        if cache_key not in self._cache:
            grad_fn = self._grad_fn(preconditioned=True, **kwargs)

            def step(key, params, obs):
                grad, ll = grad_fn(key, params, obs)
                new = sgmcmc.tree_axpy(epsilon, grad, params)
                return m.project_parameters(new), ll

            self._cache[cache_key] = jax.jit(step)
        self.parameters, _ = self._cache[cache_key](
            self.next_key(), self.parameters, self.observations)
        return self.parameters

    def exact_logjoint(self, return_loglike: bool = False):
        """loglikelihood + logprior at the current parameters
        (`exact_logjoint`, `sgmcmc_sampler.py:38-49`)."""
        loglikelihood = self.exact_loglikelihood()
        logprior = float(self.model.logprior(self.prior, self.parameters))
        if return_loglike:
            return dict(logjoint=loglikelihood + logprior,
                        loglikelihood=loglikelihood)
        return loglikelihood + logprior

    def sample_sgld_cv(self, epsilon, centering_parameters,
                       centering_gradient, **kwargs):
        """SGLD with control variates (`sample_sgld_cv`,
        `sgmcmc_sampler.py:569-611`): grad = full_grad(center) +
        subseq_grad(theta) - subseq_grad(center), same subsequence draw."""
        grad_fn = self._grad_fn(**kwargs)
        key = self.next_key()
        cache_key = ("sgld_cv_step", float(epsilon))
        if cache_key not in self._cache:
            m = self.model
            T = self.T

            def step(key, params, obs, c_params, c_grad):
                new, ll = sgmcmc.sgld_cv_step(
                    key, params, obs, grad_fn, c_params, c_grad, epsilon, T)
                return m.project_parameters(new), ll

            self._cache[cache_key] = jax.jit(step)
        self.parameters, _ = self._cache[cache_key](
            key, self.parameters, self.observations, centering_parameters,
            centering_gradient)
        return self.parameters

    def step_adagrad(self, epsilon, **kwargs):
        if not hasattr(self, "_adagrad_state"):
            self._adagrad_state = sgmcmc.adagrad_init(self.parameters)
        grad_fn = self._grad_fn(**kwargs)
        key = self.next_key()
        m = self.model
        cache_key = ("adagrad_step", float(epsilon))
        if cache_key not in self._cache:
            def step(key, params, state, obs):
                new, state, ll = sgmcmc.adagrad_step(key, params, state, obs,
                                                     grad_fn, epsilon)
                return m.project_parameters(new), state, ll
            self._cache[cache_key] = jax.jit(step)
        self.parameters, self._adagrad_state, _ = self._cache[cache_key](
            key, self.parameters, self._adagrad_state, self.observations)
        return self.parameters

    def project_parameters(self, **kwargs):
        if not kwargs:
            if "project" not in self._cache:
                self._cache["project"] = jax.jit(self.model.project_parameters)
            self.parameters = self._cache["project"](self.parameters)
        else:
            self.parameters = self.model.project_parameters(self.parameters,
                                                            **kwargs)
        return self.parameters

    # -- fit ---------------------------------------------------------------
    def get_iter_step(self, iter_type: str):
        """iter_type -> bound step method (`get_iter_step`,
        `sgmcmc_sampler.py:896-947`).  'custom' takes
        ``iter_funcs=[(method_name, kwargs), ...]`` per iteration, like
        the reference's iter_func_names/iter_func_kwargs pairs."""
        if iter_type == "custom":
            def custom_step(epsilon=None, iter_funcs=(), **_):
                for name, fkw in iter_funcs:
                    getattr(self, name)(**fkw)
                return self.parameters

            return custom_step
        table = {
            "SGLD": self.sample_sgld,
            "SGRLD": self.sample_sgrld,
            "SGD": self.step_sgd,
            "SGRD": self.step_precondition_sgd,
            "ADAGRAD": self.step_adagrad,
        }
        if iter_type not in table:
            raise ValueError(f"Unrecognized iter_type '{iter_type}'")
        return table[iter_type]

    def fit(self, iter_type: str, num_iters: int, epsilon: float = 0.1,
            output_all: bool = False, steps_per_iteration: int = 1,
            tqdm=None, **kwargs):
        """Python-loop fit (checkpointable, reference semantics).

        For maximum-throughput runs use `fit_scan`, which compiles the whole
        loop into one XLA program.
        """
        step = self.get_iter_step(iter_type)
        params_list = [self.parameters] if output_all else None
        it = range(num_iters)
        if tqdm is not None:
            it = tqdm(it)
        for _ in it:
            for _ in range(steps_per_iteration):
                step(epsilon, **kwargs)
            if output_all:
                params_list.append(self.parameters)
        return params_list if output_all else self.parameters

    def fit_timed(self, iter_type: str, max_time: float, epsilon: float = 0.1,
                  steps_per_iteration: int = 1, max_samples: int = 2000,
                  chunk_iters: int | None = None, **kwargs):
        """Wall-clock-budgeted fit (`fit_timed`, `sgmcmc_sampler.py:723`).

        The recorded trace is adaptively thinned to at most ~2*max_samples
        entries (keeping every k-th iterate, doubling k as needed), so the
        host transfers of a multi-thousand-step trace stay bounded.

        ``chunk_iters`` switches from per-step Python calls (one dispatch
        and one host sync each) to whole-chunk-compiled `fit_scan`
        executions between wall-clock checks — the fast path for real
        wall-clock budgets on an accelerator.
        """
        if chunk_iters is not None:
            from ..io.checkpoint import unstack_trace
            params_list = [self.parameters]
            times = [0.0]
            stride, it = 1, 0
            start = time.perf_counter()
            while time.perf_counter() - start < max_time:
                trace = self.fit_scan(
                    iter_type, num_iters=chunk_iters, epsilon=epsilon,
                    steps_per_iteration=steps_per_iteration, **kwargs)
                chunk = unstack_trace(jax.device_get(trace))
                now = time.perf_counter() - start
                prev = times[-1]
                # same every-stride-th thinning as the per-step path below
                # (timestamps interpolate within the chunk; the first
                # chunk's span includes its one-off compile, as the first
                # per-step iteration does)
                for i, p in enumerate(chunk):
                    it += 1
                    if it % stride:
                        continue
                    params_list.append(p)
                    times.append(prev + (now - prev) * (i + 1) / len(chunk))
                    if max_samples and len(params_list) > 2 * max_samples:
                        params_list = params_list[::2]
                        times = times[::2]
                        stride *= 2
            return params_list, times
        step = self.get_iter_step(iter_type)
        params_list = [self.parameters]
        times = [0.0]
        stride, it = 1, 0
        start = time.perf_counter()
        while time.perf_counter() - start < max_time:
            for _ in range(steps_per_iteration):
                step(epsilon, **kwargs)
            it += 1
            if it % stride == 0:
                params_list.append(self.parameters)
                times.append(time.perf_counter() - start)
                if max_samples and len(params_list) > 2 * max_samples:
                    params_list = params_list[::2]
                    times = times[::2]
                    stride *= 2
        return params_list, times

    def fit_evaluate(self, iter_type: str, max_time: float,
                     epsilon: float = 0.1, metric_functions=None,
                     sample_functions=None, eval_freq: float = 5.0,
                     steps_per_iteration: int = 1, **kwargs):
        """Wall-clock-budgeted fit with an inline evaluator
        (`fit_evaluate`, `sgmcmc_sampler.py:757-894`): sampler time and
        evaluation time are tracked separately; metrics are recorded every
        ``eval_freq`` seconds of sampler time."""
        from ..evaluation.evaluator import SamplerEvaluator
        evaluator = SamplerEvaluator(self, metric_functions=metric_functions,
                                     sample_functions=sample_functions)
        step = self.get_iter_step(iter_type)
        sampler_time = 0.0
        last_eval = 0.0
        while sampler_time < max_time:
            t0 = time.perf_counter()
            for _ in range(steps_per_iteration):
                step(epsilon, **kwargs)
            sampler_time += time.perf_counter() - t0
            evaluator.iteration += 1
            evaluator.elapsed_time = sampler_time
            if sampler_time - last_eval >= eval_freq:
                evaluator.eval_metric_functions(self, evaluator.iteration,
                                                time=sampler_time)
                evaluator.eval_sample_functions(self, evaluator.iteration,
                                                time=sampler_time)
                last_eval = sampler_time
        evaluator.eval_metric_functions(self, evaluator.iteration,
                                        time=sampler_time)
        return evaluator

    # -- multi-chain plumbing ----------------------------------------------
    def _chain_init_params(self, num_chains: int, chain_init):
        """Initial stacked [C, ...] parameter pytree for a multi-chain fit.

        ``chain_init``: a stacked pytree (used as-is), ``"prior"`` (C
        independent prior draws — the pooled-posterior / R-hat protocol),
        or ``"replicate"`` (broadcast the current parameters; if the
        sampler already holds C stacked chains from a previous call, the
        fit continues them).
        """
        C = int(num_chains)
        if not isinstance(chain_init, str):
            lead = jax.tree_util.tree_leaves(chain_init)[0].shape[0]
            if lead != C:
                raise ValueError(
                    f"chain_init pytree has leading axis {lead}, "
                    f"expected num_chains={C}")
            self._num_chains = C
            self.parameters = chain_init
            return chain_init
        if chain_init == "replicate":
            if self._num_chains == C:
                return self.parameters          # continue existing chains
            if self._num_chains is not None:
                raise ValueError(
                    f"sampler holds {self._num_chains} stacked chains; "
                    f"call select_chain() before re-fitting with "
                    f"num_chains={C}")
            params = jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(x, (C,) + x.shape), self.parameters)
        elif chain_init == "prior":
            params = self._stacked_prior_draws(C)
        else:
            raise ValueError(f"Unrecognized chain_init '{chain_init}'")
        self._num_chains = C
        self.parameters = params
        return params

    def _stacked_prior_draws(self, C: int):
        """Stacked [C, ...] independent (projected) prior draws — on the
        host CPU backend (no accelerator compile of the gamma/Wishart
        samplers), dtype-matched to the resident parameters.  Pure apart
        from consuming PRNG keys: does NOT set self.parameters."""
        keys = jax.random.split(self.next_key(), C)
        m = self.model
        try:
            cpu = jax.local_devices(backend="cpu")[0]
        except RuntimeError:
            cpu = None
        draw = jax.vmap(
            lambda k: m.project_parameters(m.sample_prior(self.prior, k)))
        if cpu is not None:
            with jax.default_device(cpu):
                params = jax.jit(draw)(jax.device_put(keys, cpu))
            params = jax.device_put(params, jax.devices()[0])
        else:
            params = jax.jit(draw)(keys)
        # match the resident parameter dtypes (CPU x64 vs device f32);
        # the sampler may currently hold stacked [C', ...] chains — read
        # dtypes only, never shapes
        cur_dtypes = jax.tree_util.tree_map(lambda x: x.dtype,
                                            self.parameters)
        return jax.tree_util.tree_map(
            lambda drawn, dt: drawn.astype(dt), params, cur_dtypes)

    def prior_chain_draws(self, num_chains: int, first=None):
        """Public overdispersed chain-init builder: stacked [C, ...]
        parameters with chain 0 at ``first`` (default: the sampler's
        current single-chain parameters) and chains 1..C-1 independent
        prior draws — the multi-chain R-hat protocol
        (artifacts/reference_comparison.py).  Does not mutate sampler
        state (beyond consuming PRNG keys); pass the result to
        ``fit_scan(chain_init=...)``.
        """
        C = int(num_chains)
        if first is None:
            if self._num_chains is not None:
                raise ValueError(
                    "sampler holds stacked chains; pass `first` "
                    "explicitly (e.g. select_chain() output)")
            first = self.parameters
        first_b = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x)[None], first)
        if C == 1:
            return first_b
        draws = self._stacked_prior_draws(C - 1)
        return jax.tree_util.tree_map(
            lambda f, d: jnp.concatenate([f, d.astype(f.dtype)], axis=0),
            first_b, draws)

    def select_chain(self, i: int = 0):
        """Collapse a stacked multi-chain state back to chain ``i``."""
        if self._num_chains is None:
            return self.parameters
        self.parameters = jax.tree_util.tree_map(lambda x: x[i],
                                                 self.parameters)
        if hasattr(self, "_adagrad_state") and self._adagrad_state is not None:
            lead = jax.tree_util.tree_leaves(self._adagrad_state)[0]
            if lead.ndim and lead.shape[0] == self._num_chains:
                self._adagrad_state = jax.tree_util.tree_map(
                    lambda x: x[i], self._adagrad_state)
        self._num_chains = None
        return self.parameters

    # recorded traces beyond this size trigger a warning pointing at
    # record=k / record="none" (a [C, N, ...] trace at the flagship
    # 8192-chain config would silently OOM otherwise)
    TRACE_WARN_BYTES = 2 << 30

    def _record_plan(self, num_iters: int, steps_per_iteration: int, record,
                     num_chains: int | None = None):
        """(effective scan iters, inner steps per iter, output_all).

        Any ``record`` interval is accepted: if it does not divide
        ``num_iters`` the run is truncated to the largest multiple (with a
        warning) rather than raising.  Warns when the recorded trace
        would exceed `TRACE_WARN_BYTES` (e.g. ``record="all"`` with many
        chains), pointing at ``record=k`` / ``"none"``.
        """
        import warnings
        if record == "none":
            return num_iters, steps_per_iteration, False
        thin = 1 if record == "all" else int(record)
        if thin < 1:
            raise ValueError(f"record={record!r} must be >= 1")
        if thin > num_iters:
            raise ValueError(
                f"record={record!r} exceeds num_iters={num_iters}: "
                f"nothing would be recorded")
        n_rec = num_iters // thin
        if n_rec * thin != num_iters:
            warnings.warn(
                f"record={record!r} does not divide num_iters={num_iters}; "
                f"running {n_rec * thin} iterations "
                f"({num_iters - n_rec * thin} dropped)", stacklevel=3)
        # estimate the host/device trace footprint from the (per-chain)
        # parameter pytree
        leaves = jax.tree_util.tree_leaves(self.parameters)
        per_iter = sum(x.size * x.dtype.itemsize for x in leaves)
        if self._num_chains:
            per_iter //= self._num_chains
        C = num_chains or 1
        total = per_iter * n_rec * C
        if total > self.TRACE_WARN_BYTES:
            warnings.warn(
                f"recorded trace would be ~{total / 2**30:.1f} GiB "
                f"({C} chains x {n_rec} recorded iters); thin with "
                f"record=k or pass record='none' (pooled moments don't "
                f"need every autocorrelated step)", stacklevel=3)
        return n_rec, steps_per_iteration * thin, True

    def fit_scan(self, iter_type: str, num_iters: int, epsilon: float = 0.1,
                 steps_per_iteration: int = 1, num_chains: int | None = None,
                 chain_init="replicate", record="all",
                 return_aux: bool = False, mesh=None,
                 n_particle_devices: int | None = None,
                 island_fused: bool = False, **kwargs):
        """Whole-loop-compiled fit returning the full parameter trace
        (SGLD / SGRLD / SGD / SGRD / ADAGRAD / SGLD-CV — every gradient
        iter_type of `get_iter_step`, `sgmcmc_sampler.py:896-947`).
        ADAGRAD carries its moment state across calls
        (`self._adagrad_state`); SGLD-CV takes ``centering_parameters`` /
        ``centering_gradient`` kwargs.

        ``num_chains=C`` runs C independent vmapped chains in ONE compiled
        program — the accelerator form of the reference's
        shell-job-per-chain parallelism (`driver_utils.py:79`) and the
        flagship-throughput path (see bench.py / PERF.md).  The
        trace gains a leading chain axis ([C, iters, ...]); afterwards the
        sampler holds the stacked [C, ...] parameters (``select_chain(i)``
        collapses back).  ``chain_init`` seeds the chains (see
        `_chain_init_params`); ``record`` is ``"all"`` (default), an int
        k (keep every k-th iterate — pooled moments don't need every
        autocorrelated step, and un-thinned multi-chain traces dominate
        host-transfer cost), or ``"none"`` (no
        trace).  ``return_aux=True`` additionally returns the recorded
        per-iteration loglikelihood aux (the benchmark's sync scalar).
        """
        if mesh is not None or n_particle_devices is not None:
            return self._fit_scan_distributed(
                iter_type, num_iters, epsilon, steps_per_iteration,
                num_chains, chain_init, record, return_aux, mesh,
                n_particle_devices, island_fused, **kwargs)
        m = self.model
        T = self.T
        n_rec, steps_eff, output_all = self._record_plan(
            num_iters, steps_per_iteration, record, num_chains=num_chains)
        if iter_type == "ADAGRAD":
            grad_fn = self._grad_fn(**kwargs)

            def sstep(key, params, state, obs):
                return sgmcmc.adagrad_step(key, params, state, obs,
                                           grad_fn, epsilon)

            def single_fit_state(key, params, state, obs):
                return sgmcmc.fit_with_state(
                    key, params, state, obs, sstep, n_rec,
                    project_fn=m.project_parameters,
                    steps_per_iter=steps_eff, output_all=output_all)

            if num_chains is None:
                runner = jax.jit(single_fit_state)
                params0 = self.parameters
            else:
                C = int(num_chains)
                params0 = self._chain_init_params(C, chain_init)

                def runner_multi(key, params, state, obs):
                    keys = jax.random.split(key, C)
                    return jax.vmap(single_fit_state,
                                    in_axes=(0, 0, 0, None))(
                        keys, params, state, obs)

                runner = jax.jit(runner_multi)
            state0 = getattr(self, "_adagrad_state", None)
            if state0 is None or (num_chains is not None and
                                  jax.tree_util.tree_leaves(state0)[0].shape
                                  != jax.tree_util.tree_leaves(
                                      params0)[0].shape):
                state0 = (sgmcmc.adagrad_init(params0) if num_chains is None
                          else jax.vmap(sgmcmc.adagrad_init)(params0))
            params, state, trace, aux = runner(
                self.next_key(), params0, state0, self.observations)
            self.parameters, self._adagrad_state = params, state
            return (trace, aux) if return_aux else trace
        if iter_type == "SGLD":
            grad_fn = self._grad_fn(**kwargs)

            def step(key, params, obs):
                return sgmcmc.sgld_step(key, params, obs, grad_fn, epsilon,
                                        T)
        elif iter_type == "SGRLD":
            grad_fn = self._grad_fn(preconditioned=True, **kwargs)
            precond = sgmcmc.Preconditioner(
                m.precondition, m.precondition_noise, m.correction_term)

            def step(key, params, obs):
                return sgmcmc.sgrld_step(key, params, obs, grad_fn, precond,
                                         epsilon, T)
        elif iter_type == "SGD":
            grad_fn = self._grad_fn(**kwargs)

            def step(key, params, obs):
                return sgmcmc.sgd_step(key, params, obs, grad_fn, epsilon)
        elif iter_type == "SGRD":
            grad_fn = self._grad_fn(preconditioned=True, **kwargs)

            def step(key, params, obs):
                grad, ll = grad_fn(key, params, obs)
                return sgmcmc.tree_axpy(epsilon, grad, params), ll
        elif iter_type == "SGLD-CV":
            c_params = kwargs.pop("centering_parameters")
            c_grad = kwargs.pop("centering_gradient")
            grad_fn = self._grad_fn(**kwargs)

            def step(key, params, obs):
                return sgmcmc.sgld_cv_step(key, params, obs, grad_fn,
                                           c_params, c_grad, epsilon, T)
        else:
            raise NotImplementedError(
                f"fit_scan supports SGLD/SGRLD/SGD/SGRD/ADAGRAD/SGLD-CV, "
                f"not '{iter_type}'")

        cache_key = ("fit_scan", iter_type, float(epsilon), num_iters,
                     steps_per_iteration, num_chains, record, return_aux,
                     tuple(sorted(kwargs.items(), key=lambda kv: kv[0]))
                     if iter_type != "SGLD-CV"    # step closes over arrays
                     and all(isinstance(v, (int, float, str, bool,
                                            type(None)))
                             for v in kwargs.values()) else None)
        if cache_key not in self._cache or cache_key[-1] is None:
            def single_fit(key, params, obs):
                return sgmcmc.fit(
                    key, params, obs, step, n_rec,
                    project_fn=m.project_parameters,
                    steps_per_iter=steps_eff, output_all=output_all)

            if num_chains is None:
                runner = single_fit
            else:
                C = int(num_chains)

                def runner(key, params, obs):
                    keys = jax.random.split(key, C)
                    return jax.vmap(single_fit, in_axes=(0, 0, None))(
                        keys, params, obs)

            self._cache[cache_key] = jax.jit(runner)
        params0 = (self.parameters if num_chains is None else
                   self._chain_init_params(int(num_chains), chain_init))
        params, trace, aux = self._cache[cache_key](
            self.next_key(), params0, self.observations)
        self.parameters = params
        return (trace, aux) if return_aux else trace

    def _fit_scan_distributed(self, iter_type, num_iters, epsilon,
                              steps_per_iteration, num_chains, chain_init,
                              record, return_aux, mesh, n_particle_devices,
                              island_fused, **kwargs):
        """`fit_scan(mesh=...)`: the multi-chip path (SURVEY.md §2.4).

        Routes the fit through `parallel/training.make_distributed_sgld_step`
        — chains sharded over the mesh's 'chain' axis, each chain's
        particle filter sharded over its 'particle' axis (psum-normalized
        gather smoothers, or per-shard fused Pallas islands with
        ``island_fused=True``; the >= 256-particles-per-device island-bias
        gate is enforced by that layer's warning).  Same trace/record/
        chain_init conventions as the vmap path; requires iter_type='SGLD'
        and the PF gradient (kind='pf'), the distributed step's contract.
        """
        from ..parallel import sharding, training
        m = self.model
        if iter_type != "SGLD":
            raise NotImplementedError(
                "fit_scan(mesh=...) routes to the distributed SGLD step "
                "(parallel/training.py); other iter types run chain-"
                "parallel via fit_scan(num_chains=...)")
        if (kwargs.get("kind") or "pf") != "pf" or not m.has_pf:
            raise NotImplementedError(
                "fit_scan(mesh=...) shards the particle-filter gradient; "
                f"model '{m.name}' must provide the PF path (kind='pf')")
        if mesh is None:
            devs = jax.devices()
            P = int(n_particle_devices)
            if P < 1 or len(devs) % P:
                raise ValueError(
                    f"n_particle_devices={P} must divide the "
                    f"{len(devs)}-device platform")
            mesh = sharding.make_mesh(n_chain_devices=len(devs) // P,
                                      n_particle_devices=P,
                                      devices=devs)
        n_chain_dev = int(mesh.shape["chain"])
        C = int(num_chains) if num_chains is not None else n_chain_dev
        if C % n_chain_dev:
            raise ValueError(
                f"num_chains={C} must be a multiple of the mesh chain "
                f"axis ({n_chain_dev})")
        n_rec, steps_eff, output_all = self._record_plan(
            num_iters, steps_per_iteration, record, num_chains=C)
        cfg = self._score_config(**kwargs)
        kernel_name = kwargs.get("kernel")
        cache_key = ("dist_fit", float(epsilon), n_rec, steps_eff,
                     output_all, C, island_fused, cfg, kernel_name,
                     kwargs.get("is_scaled", True), mesh)
        if cache_key not in self._cache:
            fused = m.get_fused(kernel_name) if m.get_fused else None
            step = training.make_distributed_sgld_step(
                m.get_kernel(kernel_name), m.grad_statistic,
                m.grad_statistic_dim, m.unpack_grad,
                lambda p: m.grad_logprior(self.prior, p), cfg, self.T,
                mesh, epsilon=float(epsilon),
                prior_mean_var_fn=m.prior_mean_var,
                project_fn=m.project_parameters,
                is_scaled=kwargs.get("is_scaled", True),
                fused_model=fused, island_fused=island_fused,
                warn_small_islands=kwargs.get("warn_small_islands", True))
            self._cache[cache_key] = training.make_distributed_fit_recorded(
                step, n_rec, steps_eff, output_all)
        params0 = self._chain_init_params(C, chain_init)
        keys = jax.random.split(self.next_key(), C)
        params0 = sharding.shard_chain_states(mesh, params0)
        keys = sharding.shard_chain_states(mesh, keys)
        params, trace, aux = self._cache[cache_key](
            keys, params0, self.observations)
        self.parameters = params
        if output_all:
            # [n_rec, C, ...] -> the fit_scan [C, n_rec, ...] convention
            trace = jax.tree_util.tree_map(
                lambda x: jnp.swapaxes(x, 0, 1), trace)
        aux = jnp.swapaxes(aux, 0, 1) if output_all else aux.T
        return (trace, aux) if return_aux else trace

    def fit_scan_chunked(self, iter_type: str, num_iters: int,
                         chunk_iters: int = 250, epsilon: float = 0.1,
                         num_chains: int | None = None,
                         chain_init="replicate", record="all", **kwargs):
        """`fit_scan` split into chunked program executions.

        Identical chain law to one long `fit_scan` (the PRNG threads
        through `self._key` between chunks); each chunk compiles once and
        runs as its own XLA program.  Use it for very long chains whose
        one on-device trace would not fit in device memory, or to bound
        the length of any one program execution (progress reporting,
        checkpointing between chunks).  Returns the trace as a list
        of parameter pytrees on host — or, with ``num_chains=C``, as ONE
        host pytree with leaves [C, num_recorded, ...] (chunk traces
        concatenated along the iteration axis; ``record`` thins as in
        `fit_scan`, and each chunk is one batched host transfer).
        """
        from ..io.checkpoint import unstack_trace

        # size chunks to multiples of the record interval so every chunk
        # divides cleanly (no per-chunk truncation warnings, no raise on
        # an undersized remainder chunk); a final remainder smaller than
        # the interval is dropped with one warning
        thin = 1 if record in ("all", "none") else int(record)
        if thin < 1:
            raise ValueError(f"record={record!r} must be >= 1")
        if thin > min(chunk_iters, num_iters):
            raise ValueError(
                f"record={record!r} exceeds chunk_iters={chunk_iters} / "
                f"num_iters={num_iters}: nothing would be recorded")

        def next_chunk(done):
            n = (min(chunk_iters, num_iters - done) // thin) * thin
            if n == 0 and num_iters - done > 0:
                import warnings
                warnings.warn(
                    f"fit_scan_chunked: dropping the final "
                    f"{num_iters - done} iterations (< record={record!r})",
                    stacklevel=3)
            return n

        if num_chains is not None:
            chunks, done = [], 0
            while (n := next_chunk(done)) > 0:
                trace = self.fit_scan(
                    iter_type, num_iters=n, epsilon=epsilon,
                    num_chains=num_chains, chain_init=chain_init,
                    record=record, **kwargs)
                chain_init = "replicate"    # continue the stacked chains
                chunks.append(jax.device_get(trace))
                done += n
            return jax.tree_util.tree_map(
                lambda *xs: np.concatenate(xs, axis=1), *chunks)
        if record == "none":
            raise ValueError("fit_scan_chunked exists to return the trace; "
                             "use fit_scan(record='none') directly")
        out = []
        done = 0
        while (n := next_chunk(done)) > 0:
            trace = self.fit_scan(iter_type, num_iters=n, epsilon=epsilon,
                                  record=record, **kwargs)
            out.extend(unstack_trace(jax.device_get(trace)))
            done += n
        return out

    # -- prediction / latent recovery --------------------------------------
    def predict(self, target: str = "latent", kind: str | None = None,
                pf: str | None = None, N: int = 1000, squared=False,
                lag=None, num_samples: int | None = None,
                distr: str | None = None, **kwargs):
        """Latent/observation prediction (`predict`,
        `sgmcmc_sampler.py:956-1123`; PF path `pf_latent_var_distr` /
        `pf_y_distr`, e.g. `svm/helper.py:249-294`).

        target 'latent' or 'y'; ``lag`` selects p(. | y_{<= t+lag}):
        None = smoothed, 0 = filtered (PF path: forces ``pf='filter'``,
        matching `svm/helper.py:253-258`), k >= 1 = fixed-lag.
        ``num_samples`` switches from distributions to posterior draws
        (`latent_var_sample` / `y_sample`; exact-message path only);
        ``distr`` selects 'joint' (default, FFBS paths) or 'marginal'
        (independent per-t draws) as in the reference `predict`
        (`sgmcmc_sampler.py:956-1045`).
        """
        if target not in ("latent", "y"):
            raise ValueError(f"Unrecognized target '{target}'")
        m = self.model
        if kind is None:
            kind = self._default_kind()
        if kind == "marginal":
            if m.name.startswith("lgssm"):
                from ..models import lgssm as lgssm_mod
                p = self.parameters
                if num_samples is not None:
                    fn = (lgssm_mod.latent_var_sample if target == "latent"
                          else lgssm_mod.y_sample)
                    return np.asarray(fn(p, self.next_key(),
                                         self.observations,
                                         num_samples=num_samples,
                                         distr=distr or "joint", lag=lag))
                fn = (lgssm_mod.latent_var_distr if target == "latent"
                      else lgssm_mod.y_distr)
                mean, cov = fn(p, self.observations, lag=lag)
                return np.asarray(mean), np.asarray(cov)
            if m.latent_var_distr is not None and target == "latent":
                # discrete-state models: probs [T, K] / FFBS z draws
                if num_samples is not None:
                    return np.asarray(m.latent_var_sample(
                        self.parameters, self.next_key(),
                        self.observations, distr=distr or "joint", lag=lag,
                        num_samples=num_samples))
                return np.asarray(m.latent_var_distr(
                    self.parameters, self.observations, lag=lag))
            raise NotImplementedError(
                f"{m.name} has no analytic predict for target='{target}'")
        # ---- PF path: elementwise statistics over the full sequence ------
        if num_samples is not None:
            raise NotImplementedError(
                "joint posterior sampling is not available on the PF path "
                "(reference contract: `latent_var_sample` raises for "
                "PF-only models, `svm/sampler.py:67-78`)")
        pf, fixed_lag, stat_fn, stat_dim = self._pf_predict_setup(
            target, pf, lag, squared)
        from ..ops.buffered import run_buffered_pf
        T = self.T
        kernel_name = kwargs.get("kernel")
        cache_key = ("pf_distr", target, pf, N, lag, T, kernel_name,
                     kwargs.get("resampler", "multinomial"),
                     kwargs.get("resample_mode", "auto"))
        if cache_key not in self._cache:
            def run(key, params, obs):
                out = run_buffered_pf(
                    m.get_kernel(kernel_name), stat_fn,
                    params, obs, key=key, n_particles=N,
                    statistic_dim=stat_dim, smoother=pf,
                    prior_mean=m.prior_mean_var(params)[0],
                    prior_var=m.prior_mean_var(params)[1],
                    resampler=kwargs.get("resampler", "multinomial"),
                    resample_mode=kwargs.get("resample_mode", "auto"),
                    elementwise=True, window_length=T,
                    fixed_lag=fixed_lag)
                return out.mean_statistic

            self._cache[cache_key] = jax.jit(run)
        stat = self._cache[cache_key](
            self.next_key(), self.parameters, self.observations)
        mean, cov = self._pf_stat_to_moments(target, squared,
                                             stat.reshape(T, stat_dim))
        return np.asarray(mean), np.asarray(cov)

    def _pf_predict_setup(self, target, pf, lag, squared):
        """Shared validation + statistic selection for the PF predict
        paths (single-sequence and padded multi-sequence).

        lag/pf contract (`pf_latent_var_distr`, `svm/helper.py:253-258`):
        lag=0 needs the filter; smoothing must not use the filter.
        ``squared`` is a GARCH-only contract in the reference too
        (`garch/helper.py:236-267`) — validated BEFORE the PF
        compiles/executes, so an invalid call never pays a full
        particle-filter compile and run."""
        m = self.model
        if target not in ("latent", "y"):
            raise ValueError(f"Unrecognized target '{target}'")
        if pf is None:
            pf = "filter" if lag == 0 else "poyiadjis_N"
        if lag == 0 and pf != "filter":
            raise ValueError("pf must be 'filter' for lag = 0")
        if lag is None and pf == "filter":
            raise ValueError("pf must not be 'filter' for smoothing")
        fixed_lag = int(lag) if (lag is not None and lag > 0) else None
        if squared and target != "y" and m.name != "garch":
            raise NotImplementedError(
                f"squared=True latent moments are GARCH-only, not {m.name}")
        if target == "y":
            if m.y_statistic is None:
                raise NotImplementedError(
                    f"{m.name} has no PF observation-moment statistic")
            return pf, fixed_lag, m.y_statistic, m.y_statistic_dim
        return pf, fixed_lag, m.suff_statistic, m.suff_statistic_dim

    def _pf_stat_to_moments(self, target, squared, stat):
        """[T, stat_dim] elementwise smoothed statistics -> per-t
        (mean, cov) via the model's moment maps (GARCH data-fit view at
        `garch/helper.py:262-267`)."""
        m = self.model
        if target == "y":
            return m.y_moments(self.parameters, stat)
        if m.latent_moments is not None:
            if squared:
                return m.latent_moments(self.parameters, stat,
                                        squared=True)
            return m.latent_moments(self.parameters, stat)
        mean = stat[:, 0].reshape(-1, 1)
        cov = (stat[:, 1] - stat[:, 0] ** 2).reshape(-1, 1, 1)
        return mean, cov

    def predictive_loglikelihood(self, num_steps_ahead: int = 5,
                                 kind: str | None = None, N: int = 1000,
                                 lag: int = 1, **kwargs):
        """k-step-ahead predictive loglikelihood
        (`pf_predictive_loglikelihood_estimate`, `svm/helper.py:187-247`;
        exact lag version for message-passing models).  Dispatches through
        the model registry — unknown models raise instead of silently
        borrowing another model's statistic."""
        m = self.model
        if kind is None:
            kind = self._default_kind()
        if kind == "marginal":
            if m.predictive_loglikelihood is None:
                raise NotImplementedError(
                    f"{m.name} has no exact predictive loglikelihood")
            cache_key = ("exact_pred_ll", int(lag))
            if cache_key not in self._cache:
                fn = m.predictive_loglikelihood
                self._cache[cache_key] = jax.jit(
                    lambda p, obs: fn(p, obs, lag=int(lag)))
            return float(self._cache[cache_key](self.parameters,
                                                self.observations))
        if m.make_predictive_stat_fn is None:
            raise NotImplementedError(
                f"{m.name} has no PF predictive-loglikelihood statistic")
        from ..ops.buffered import run_buffered_pf
        kernel_name = kwargs.get("kernel")
        # The predictive statistic closes over future-observation windows;
        # build it INSIDE the jitted closure from the obs *argument* so a
        # reassigned `sampler.observations` (even same-shape) is always the
        # array being scored — never a baked constant.  T in the key keeps
        # distinct lengths from sharing one compiled program.
        cache_key = ("pred_ll", num_steps_ahead, N, self.T, kernel_name,
                     kwargs.get("resample_mode", "auto"))
        if cache_key not in self._cache:
            def run(key, params, obs):
                stat_fn = m.make_predictive_stat_fn(obs, num_steps_ahead)
                out = run_buffered_pf(
                    m.get_kernel(kernel_name), stat_fn, params, obs, key=key,
                    n_particles=N, statistic_dim=num_steps_ahead + 1,
                    smoother="filter", logsumexp_mode=True,
                    prior_mean=m.prior_mean_var(params)[0],
                    prior_var=m.prior_mean_var(params)[1],
                    resample_mode=kwargs.get("resample_mode", "auto"))
                return out.statistics, out.loglikelihood

            self._cache[cache_key] = jax.jit(run)
        stats, loglik = self._cache[cache_key](
            self.next_key(), self.parameters, self.observations)
        out = np.array(stats)    # writable copy
        out[0] = float(loglik)   # slot 0 = loglik (`svm/helper.py:245-246`)
        return out

    # -- simulate ----------------------------------------------------------
    def simulate(self, T: int, parameters=None, return_distr: bool = False,
                 num_samples: int | None = None, include_init: bool = True):
        """Simulate dynamics (`simulate`, `sgmcmc_sampler.py:1071-1123`).

        Default: one (ys, xs) draw via the model's data generator.  For the
        LGSSM, ``return_distr=True`` returns the analytic prior moment
        trajectories (`simulate_distr`) and ``num_samples`` draws joint
        trajectories from the initial message (`simulate_paths`).
        """
        p = self.parameters if parameters is None else parameters
        if return_distr or num_samples is not None:
            if not self.model.name.startswith("lgssm"):
                raise NotImplementedError(
                    "distributional simulate supports the LGSSM")
            from ..models import lgssm as lgssm_mod
            if return_distr:
                return jax.tree_util.tree_map(
                    np.asarray,
                    lgssm_mod.simulate_distr(p, T,
                                             include_init=include_init))
            return jax.tree_util.tree_map(
                np.asarray,
                lgssm_mod.simulate_paths(p, self.next_key(), T,
                                         num_samples=num_samples,
                                         include_init=include_init))
        return self.model.generate_data(self.next_key(), p, T)

    # -- reference-name aliases (drop-in ergonomics; the reference exposes
    # these as separate methods, `sgmcmc_sampler.py:956-1123`) -------------
    def prior_init(self):
        """Draw fresh parameters from the prior (`prior_init`,
        `sgmcmc_sampler.py:139-146`; also done at construction)."""
        self.parameters = _draw_prior_on_cpu(
            self.model.sample_prior, self.model.project_parameters,
            self.prior, self.next_key())
        return self.parameters

    def latent_var_distr(self, lag=None, **kwargs):
        return self.predict(target="latent", lag=lag, **kwargs)

    def latent_var_sample(self, num_samples: int = 1, **kwargs):
        return self.predict(target="latent", num_samples=num_samples,
                            **kwargs)

    def y_distr(self, lag=None, **kwargs):
        return self.predict(target="y", lag=lag, **kwargs)

    def y_sample(self, num_samples: int = 1, **kwargs):
        return self.predict(target="y", num_samples=num_samples, **kwargs)

    def simulate_distr(self, T: int, parameters=None, include_init=True):
        return self.simulate(T, parameters=parameters, return_distr=True,
                             include_init=include_init)


def pack_sequences(sequences):
    """List of [T_i, ...] arrays -> (padded [n_seq, T_max, ...], lengths)."""
    import numpy as np
    lengths = np.array([s.shape[0] for s in sequences], np.int32)
    T_max = int(lengths.max())
    trail = tuple(np.asarray(sequences[0]).shape[1:])
    packed = np.zeros((len(sequences), T_max) + trail,
                      dtype=np.asarray(sequences[0]).dtype)
    for i, s in enumerate(sequences):
        packed[i, :s.shape[0]] = np.asarray(s)
    return jnp.asarray(packed), lengths


class SeqSampler(Sampler):
    """Multi-sequence sampler (`SeqSGMCMCSampler`,
    `sgmcmc_sampler.py:1157-1423`): observations are a list of sequences;
    each gradient subsamples sequences and subsequences within them."""

    def __init__(self, model, observations: list, num_sequences: int = -1,
                 **kw):
        packed, lengths = pack_sequences(observations)
        self.lengths = lengths
        self.num_sequences = num_sequences
        self._sequences = observations
        super().__init__(model, packed, **kw)

    @property
    def T(self) -> int:
        return int(self.lengths.sum())

    def _grad_fn(self, preconditioned: bool = False, is_scaled: bool = True,
                 kind: str | None = None, **kwargs):
        m = self.model
        if kind is None:
            kind = self._default_kind()
        cfg = self._score_config(**kwargs)
        kernel_name = kwargs.get("kernel")
        num_sequences = kwargs.get("num_sequences", self.num_sequences)
        cache_key = ("seq_grad", kind, cfg, kernel_name, preconditioned,
                     is_scaled, num_sequences)
        if cache_key not in self._cache:
            if kind == "pf":
                score = sgmcmc.make_seq_pf_score_fn(
                    m.get_kernel(kernel_name), m.grad_statistic,
                    m.grad_statistic_dim, m.unpack_grad, cfg, self.lengths,
                    num_sequences=num_sequences,
                    prior_mean_var_fn=m.prior_mean_var,
                    fused_model=m.get_fused(kernel_name) if m.get_fused
                    else None)
            elif kind == "marginal":
                if m.windowed_marginal_gradient is None:
                    raise NotImplementedError(
                        f"{m.name} has no analytic message passing")
                score = sgmcmc.make_seq_marginal_score_fn(
                    m.windowed_marginal_gradient, cfg, self.lengths,
                    num_sequences=num_sequences)
            else:
                raise ValueError(
                    f"Unrecognized kind = '{kind}' for SeqSampler")
            precond = None
            if preconditioned:
                precond = sgmcmc.Preconditioner(
                    m.precondition, m.precondition_noise, m.correction_term)
            fn = sgmcmc.make_noisy_grad_fn(
                score, lambda p: m.grad_logprior(self.prior, p), self.T,
                is_scaled=is_scaled, preconditioner=precond)
            self._cache[cache_key] = jax.jit(fn)
        return self._cache[cache_key]

    def noisy_loglikelihood(self, **kwargs) -> float:
        _, loglik = self._grad_fn(**kwargs)(
            self.next_key(), self.parameters, self.observations)
        return self._check_finite_ll(float(loglik))

    def _sub_sampler(self, i: int) -> "Sampler":
        """Cached single-sequence Sampler view of sequence i (shares the
        model/prior; parameters are refreshed on every use)."""
        key = ("sub", i)
        if key not in self._cache:
            T_i = int(np.asarray(self.lengths)[i])
            self._cache[key] = Sampler(
                self.model, self.observations[i, :T_i], prior=self.prior,
                parameters=self.parameters)
        sub = self._cache[key]
        sub.parameters = self.parameters
        sub._key = self.next_key()
        return sub

    def predict(self, target: str = "latent", kind: str | None = None,
                pf: str | None = None, N: int = 1000, squared=False,
                lag=None, num_samples: int | None = None,
                distr: str | None = None, **kwargs) -> list:
        """Per-sequence predictions, returned as a list (the reference's
        `SeqSGMCMCSampler.predict` loops sequences,
        `sgmcmc_sampler.py:1285-1423`).

        The PF path runs ONE vmapped padded-sequence program (validity-
        masked tails) — one compile regardless of how many distinct
        segment lengths exist; exact-message and sampling paths fall back
        to the per-sequence loop."""
        m = self.model
        if kind is None:
            kind = self._default_kind()
        if kind != "pf" or num_samples is not None:
            return [self._sub_sampler(i).predict(
                target=target, kind=kind, pf=pf, N=N, squared=squared,
                lag=lag, num_samples=num_samples, distr=distr, **kwargs)
                for i in range(len(self._sequences))]
        # ---- batched padded PF path (shares Sampler.predict's PF-branch
        # validation and moments dispatch through the _pf_predict helpers)
        pf, fixed_lag, stat_fn, stat_dim = self._pf_predict_setup(
            target, pf, lag, squared)
        from ..ops.buffered import run_buffered_pf
        n_seq = len(self._sequences)
        T_max = int(self.observations.shape[1])
        kernel_name = kwargs.get("kernel")
        cache_key = ("seq_pf_distr", target, pf, N, lag, T_max,
                     kernel_name, kwargs.get("resampler", "multinomial"),
                     kwargs.get("resample_mode", "auto"))
        if cache_key not in self._cache:
            lengths = jnp.asarray(self.lengths, jnp.int32)

            def one_seq(key, params, obs_i, T_i):
                step_valid = (jnp.arange(T_max) < T_i).astype(obs_i.dtype)
                out = run_buffered_pf(
                    m.get_kernel(kernel_name), stat_fn, params, obs_i,
                    key=key, n_particles=N, statistic_dim=stat_dim,
                    smoother=pf,
                    prior_mean=m.prior_mean_var(params)[0],
                    prior_var=m.prior_mean_var(params)[1],
                    resampler=kwargs.get("resampler", "multinomial"),
                    resample_mode=kwargs.get("resample_mode", "auto"),
                    elementwise=True, window_length=T_max,
                    fixed_lag=fixed_lag, step_valid=step_valid)
                return out.mean_statistic

            def run(key, params, obs):
                keys = jax.random.split(key, n_seq)
                return jax.vmap(
                    lambda k, o, t: one_seq(k, params, o, t))(
                    keys, obs, lengths)

            self._cache[cache_key] = jax.jit(run)
        stats = np.asarray(self._cache[cache_key](
            self.next_key(), self.parameters, self.observations))
        results = []
        lengths_np = np.asarray(self.lengths)
        for i in range(n_seq):
            T_i = int(lengths_np[i])
            stat = jnp.asarray(stats[i].reshape(T_max, stat_dim)[:T_i])
            mean, cov = self._pf_stat_to_moments(target, squared, stat)
            results.append((np.asarray(mean), np.asarray(cov)))
        return results

    def predictive_loglikelihood(self, num_sequences: int = -1,
                                 num_steps_ahead: int = 5,
                                 kind: str | None = None, N: int = 1000,
                                 lag: int = 1, **kwargs):
        """Sum of per-sequence predictive loglikelihoods over a random
        subset, rescaled by T_total / T_chosen
        (`SeqSGMCMCSampler.predictive_loglikelihood`,
        `sgmcmc_sampler.py:1224-1248`).

        The PF path runs as ONE vmapped padded-sequence program (validity-
        masked tails via ``step_valid`` + ``valid_length``) — one compile
        regardless of how many distinct segment lengths exist, unlike a
        per-sequence Python loop (one compile and one dispatch per
        length)."""
        m = self.model
        if kind is None:
            kind = self._default_kind()
        n_seq = len(self._sequences)
        lengths_np = np.asarray(self.lengths)
        idx = np.arange(n_seq)
        if num_sequences != -1:
            rng = np.random.default_rng(
                int(jax.random.randint(self.next_key(), (), 0, 2 ** 31)))
            idx = rng.choice(idx, num_sequences, replace=False)
        if kind != "pf" or m.make_predictive_stat_fn is None:
            # exact-message path: cheap per-sequence analytic recursions
            total, S = 0.0, 0.0
            for i in idx:
                total += self._sub_sampler(int(i)).predictive_loglikelihood(
                    num_steps_ahead=num_steps_ahead, kind=kind, N=N,
                    lag=lag, **kwargs)
                S += float(lengths_np[i])
            if num_sequences != -1:
                total *= float(lengths_np.sum()) / S
            return total
        from ..ops.buffered import run_buffered_pf
        kernel_name = kwargs.get("kernel")
        k_chosen = len(idx)
        cache_key = ("seq_pred_ll", num_steps_ahead, N, k_chosen,
                     kernel_name, kwargs.get("resample_mode", "auto"))
        if cache_key not in self._cache:
            lengths = jnp.asarray(self.lengths, jnp.int32)
            T_max = int(self.observations.shape[1])

            def one_seq(key, params, obs_i, T_i):
                stat_fn = m.make_predictive_stat_fn(
                    obs_i, num_steps_ahead, valid_length=T_i)
                step_valid = (jnp.arange(T_max) < T_i).astype(obs_i.dtype)
                out = run_buffered_pf(
                    m.get_kernel(kernel_name), stat_fn, params, obs_i,
                    key=key, n_particles=N,
                    statistic_dim=num_steps_ahead + 1,
                    smoother="filter", logsumexp_mode=True,
                    prior_mean=m.prior_mean_var(params)[0],
                    prior_var=m.prior_mean_var(params)[1],
                    resample_mode=kwargs.get("resample_mode", "auto"),
                    step_valid=step_valid)
                return out.statistics, out.loglikelihood

            def run(key, params, obs, chosen):
                keys = jax.random.split(key, k_chosen)
                stats, lls = jax.vmap(
                    lambda k, i: one_seq(k, params, obs[i],
                                         lengths[i]))(keys, chosen)
                return (jnp.sum(stats, axis=0), jnp.sum(lls),
                        jnp.sum(lengths[chosen]))

            self._cache[cache_key] = jax.jit(run)
        stats, loglik, S = self._cache[cache_key](
            self.next_key(), self.parameters, self.observations,
            jnp.asarray(idx, jnp.int32))
        out = np.array(stats)     # writable copy
        out[0] = float(loglik)    # slot 0 = loglik (`svm/helper.py:245-246`)
        if num_sequences != -1:
            out *= float(lengths_np.sum()) / float(S)
        return out

    def exact_loglikelihood(self) -> float:
        """Sum of per-sequence exact marginal loglikelihoods
        (`SeqSGMCMCSampler.exact_loglikelihood`,
        `sgmcmc_sampler.py:1176-1192`), computed as ONE vmapped
        validity-masked message pass over the padded sequences — one
        compile regardless of how many distinct segment lengths exist
        (the reference loops sequences; a per-sequence loop here costs
        one jit compile per distinct length)."""
        m = self.model
        if not m.has_exact:
            raise NotImplementedError(
                f"{m.name} has no exact marginal loglikelihood")
        if m.windowed_marginal_gradient is not None:
            if "seq_exact_ll" not in self._cache:
                cfg = sgmcmc.PFScoreConfig(n_particles=1,
                                           subsequence_length=-1)
                score = sgmcmc.make_seq_marginal_score_fn(
                    m.windowed_marginal_gradient, cfg, self.lengths,
                    num_sequences=-1)
                self._cache["seq_exact_ll"] = jax.jit(
                    lambda p, o: score(jax.random.PRNGKey(0), p, o)[1])
            return float(self._cache["seq_exact_ll"](self.parameters,
                                                     self.observations))
        if "exact_ll" not in self._cache:
            self._cache["exact_ll"] = jax.jit(m.marginal_loglikelihood)
        fn = self._cache["exact_ll"]
        total = 0.0
        for i, T_i in enumerate(np.asarray(self.lengths)):
            total += float(fn(self.parameters,
                              self.observations[i, :int(T_i)]))
        return total


class SeqSVMSampler(SeqSampler):
    def __init__(self, observations, **kw):
        super().__init__("svm", observations, **kw)


class SeqSVJMSampler(SeqSampler):
    def __init__(self, observations, **kw):
        super().__init__("svjm", observations, **kw)


class SeqGARCHSampler(SeqSampler):
    def __init__(self, observations, **kw):
        super().__init__("garch", observations, **kw)


class SeqLGSSMSampler(SeqSampler):
    def __init__(self, observations, **kw):
        super().__init__("lgssm", observations, **kw)


class SeqGaussHMMSampler(SeqSampler):
    def __init__(self, observations, num_states=2, m=1, **kw):
        from ..models.registry import get_model
        super().__init__(get_model("gauss_hmm", num_states=num_states,
                                   m=m), observations, **kw)


class SeqARPHMMSampler(SeqSampler):
    def __init__(self, observations, num_states=2, m=1, p=1, **kw):
        from ..models.registry import get_model
        super().__init__(get_model("arphmm", num_states=num_states, m=m,
                                   p=p), observations, **kw)


class GibbsSamplerMixin:
    """Blocked Gibbs for conjugate models (LGSSM, GaussHMM)."""

    def sample_gibbs(self):
        if self.model.gibbs_step is None:
            raise NotImplementedError(
                f"{self.model.name} has no conjugate Gibbs sampler")
        if not hasattr(self, "_gibbs_jit"):
            self._gibbs_jit = jax.jit(self.model.gibbs_step)
        self.parameters = self._gibbs_jit(
            self.next_key(), self.prior, self.parameters, self.observations)
        return self.parameters

    def get_iter_step(self, iter_type):
        if iter_type == "Gibbs":
            # reference iteration = ['sample_gibbs', 'project_parameters']
            # (`get_iter_step`, `sgmcmc_sampler.py:896-947`) — without the
            # projection the free C row makes the (C, Q, x-scale) direction
            # non-identified and the chain wanders
            def step(*a, **k):
                self.sample_gibbs()
                return self.project_parameters()

            return step
        return super().get_iter_step(iter_type)


class LGSSMSampler(GibbsSamplerMixin, Sampler):
    def __init__(self, observations=None, **kw):
        super().__init__("lgssm", observations, **kw)


class SVMSampler(Sampler):
    def __init__(self, observations=None, **kw):
        super().__init__("svm", observations, **kw)


class SVJMSampler(Sampler):
    """Stochastic-volatility jump model sampler (the model implied by the
    reference's unimportable `SVJMEPKernel`/`SVJMEPAvgKernel`)."""
    def __init__(self, observations=None, **kw):
        super().__init__("svjm", observations, **kw)


class GARCHSampler(Sampler):
    def __init__(self, observations=None, **kw):
        super().__init__("garch", observations, **kw)


class SLDSSampler:
    """Blocked-Gibbs sampler for the switching LDS
    (`slds/sampler.py`): alternates x | z, z | x, theta | x, z.  The SLDS
    has no marginal-likelihood gradients (reference contract), so this
    wrapper manages the latent states alongside the parameters.
    """

    def __init__(self, observations, num_states=2, n=1, m=1, prior=None,
                 parameters=None, seed: int = 0):
        from ..models import slds as slds_mod
        from ..models.registry import get_model
        self._mod = slds_mod
        # registry adapter view (generic driver/evaluator code reads
        # sampler.model.has_pf etc.)
        self.model = get_model("slds", num_states=num_states, n=n, m=m)
        self.observations = jnp.asarray(observations)
        self.prior = prior if prior is not None else slds_mod.default_prior(
            num_states, n, m, dtype=self.observations.dtype)
        self._key = jax.random.PRNGKey(seed)
        self.parameters = (parameters if parameters is not None else
                           _draw_prior_on_cpu(
                               slds_mod.sample_prior,
                               slds_mod.project_parameters, self.prior,
                               self.next_key()))
        T = self.observations.shape[0]
        self.z = jnp.zeros((T,), jnp.int32)
        self.x = jnp.zeros((T, n), self.observations.dtype)
        self._gibbs = jax.jit(slds_mod.gibbs_step)
        self._project = jax.jit(slds_mod.project_parameters)
        self._cache: dict[Any, Any] = {}

    def next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def sample_gibbs(self):
        self.parameters, self.x, self.z = self._gibbs(
            self.next_key(), self.prior, self.parameters, self.observations,
            self.x, self.z)
        return self.parameters

    def project_parameters(self):
        self.parameters = self._project(self.parameters)
        return self.parameters

    def exact_loglikelihood(self, given: str = "z") -> float:
        if given == "z":
            return float(self._mod.x_marginal_loglikelihood(
                self.parameters, self.observations, self.z))
        return float(self._mod.z_marginal_loglikelihood(
            self.parameters, self.observations, self.x))

    def fit(self, num_iters: int, output_all: bool = False):
        out = [self.parameters] if output_all else None
        for _ in range(num_iters):
            self.sample_gibbs()
            self.project_parameters()
            if output_all:
                out.append(self.parameters)
        return out if output_all else self.parameters

    # -- SG-MCMC via buffered complete-data gradients ---------------------
    def _score_fn(self, S: int, B: int, latent_draws: int,
                  latent_burnin: int, latent_thinning: int):
        """score(key, params, obs) -> (grad_tree, weighted loglik): sample
        a buffered window, run blocked latent Gibbs (x | z, z | x) on it,
        and average the weighted complete-data score over latent draws
        (`SLDSSampler.noisy_gradient` kind='complete',
        `slds/sampler.py:491-660`; the reference's accumulation of
        `noisy_grad_add` is broken — this implements the documented
        semantics)."""
        from ..ops.buffered import window_weights
        from ..ops.subsequence import sample_buffered_window
        mod = self._mod
        T = self.observations.shape[0]
        full = (S == -1) or (S >= T)
        W = T if full else S + 2 * B

        def sweep(params, window, carry, k):
            x, z = carry
            kx, kz = jax.random.split(k)
            x = mod.x_latent_var_sample(params, kx, window, z)
            z = mod.z_latent_var_sample(params, kz, window, x)
            return (x, z)

        def score(key, params, obs):
            dtype = obs.dtype
            k_win, k_init, k_burn, k_draw = jax.random.split(key, 4)
            if full:
                window = obs
                step_w = jnp.ones((T,), dtype)
            else:
                win = sample_buffered_window(k_win, S, B, T, "uniform",
                                             dtype)
                window = jax.lax.dynamic_slice_in_dim(
                    obs, win.window_start, W, axis=0)
                step_w, _ = window_weights(win.t1, win.tL, win.weights, W,
                                           dtype)
            K = params.num_states
            z = jax.random.randint(k_init, (W,), 0, K, dtype=jnp.int32)
            x = mod.x_latent_var_sample(params, jax.random.fold_in(
                k_init, 1), window, z)

            def burn_body(carry, k):
                return sweep(params, window, carry, k), None

            if latent_burnin > 0:
                (x, z), _ = jax.lax.scan(
                    burn_body, (x, z), jax.random.split(k_burn,
                                                        latent_burnin))

            def draw_body(carry, k):
                def thin_body(c, kk):
                    return sweep(params, window, c, kk), None

                if latent_thinning > 0:
                    carry, _ = jax.lax.scan(
                        thin_body, carry,
                        jax.random.split(k, latent_thinning))
                g, ll = mod.windowed_complete_gradient(
                    params, window, carry[0], carry[1], step_w)
                return carry, (g, ll)

            _, (grads, lls) = jax.lax.scan(
                draw_body, (x, z), jax.random.split(k_draw, latent_draws))
            grad = jax.tree_util.tree_map(lambda g: jnp.mean(g, axis=0),
                                          grads)
            return grad, jnp.mean(lls)

        return score

    # generic driver/evaluator kwargs tolerated (and ignored — the SLDS
    # has only the complete-data gradient family); anything else is a
    # typo'd latent option and must raise rather than silently run with
    # defaults
    _IGNORED_KWARGS = frozenset((
        "kind", "pf", "N", "kernel", "resampler", "resample_mode",
        "minibatch_size", "partition_style", "lambduh", "Ntilde",
        "bw_chunk", "ess_threshold"))

    def _grad_fn(self, is_scaled: bool = True, **kwargs):
        known = {"subsequence_length", "buffer_length", "latent_draws",
                 "latent_burnin", "latent_thinning"} | self._IGNORED_KWARGS
        unknown = set(kwargs) - known
        if unknown:
            raise TypeError(f"SLDSSampler got unknown options {unknown}")
        S = kwargs.get("subsequence_length", -1)
        B = max(kwargs.get("buffer_length", 0), 0)
        latent_draws = kwargs.get("latent_draws", 1)
        latent_burnin = kwargs.get("latent_burnin", 5)
        latent_thinning = kwargs.get("latent_thinning", 5)
        cache_key = ("grad", S, B, latent_draws, latent_burnin,
                     latent_thinning, is_scaled)
        if cache_key not in self._cache:
            T = self.observations.shape[0]
            score = self._score_fn(S, B, latent_draws, latent_burnin,
                                   latent_thinning)
            fn = sgmcmc.make_noisy_grad_fn(
                score, lambda p: self._mod.grad_logprior(self.prior, p), T,
                is_scaled=is_scaled)
            self._cache[cache_key] = jax.jit(fn)
        return self._cache[cache_key]

    def noisy_gradient(self, is_scaled: bool = True,
                       check_finite: bool = True, **kwargs):
        grad, _ = self._grad_fn(is_scaled=is_scaled, **kwargs)(
            self.next_key(), self.parameters, self.observations)
        if check_finite and Sampler._grad_has_nan(self, grad):
            raise ValueError("NaNs in gradient")
        return grad

    def noisy_loglikelihood(self, **kwargs) -> float:
        _, ll = self._grad_fn(**kwargs)(
            self.next_key(), self.parameters, self.observations)
        return Sampler._check_finite_ll(float(ll))

    def noisy_logjoint(self, return_loglike: bool = False, **kwargs):
        """Noisy complete-data logjoint = noisy loglikelihood + logprior
        (the `noisy_logjoint` evaluator contract,
        `sgmcmc_sampler.py:246-290`)."""
        ll = self.noisy_loglikelihood(**kwargs)
        lj = ll + float(self._mod.logprior(self.prior, self.parameters))
        if return_loglike:
            return dict(logjoint=lj, loglikelihood=ll)
        return lj

    def sample_sgld(self, epsilon, **kwargs):
        grad_fn = self._grad_fn(**kwargs)
        T = self.observations.shape[0]
        cache_key = ("sgld",) + tuple(sorted(kwargs.items())) \
            + (float(epsilon),)
        if cache_key not in self._cache:
            def step(key, params, obs):
                new, ll = sgmcmc.sgld_step(key, params, obs, grad_fn,
                                           epsilon, T)
                return self._mod.project_parameters(new), ll

            self._cache[cache_key] = jax.jit(step)
        self.parameters, _ = self._cache[cache_key](
            self.next_key(), self.parameters, self.observations)
        return self.parameters


class SCIRSamplerMixin:
    """SGLD with the Stochastic Cox-Ingersoll-Ross exact Gamma-process
    update on the transition simplex (Baker et al. 2018;
    `CIRSamplerMixin.sample_sgld`, `hmm_helper.py:489-524`): the pi
    slot carries the *unscaled* Dirichlet sufficient statistic
    (summed pairwise posteriors + prior alpha) and is resampled by
    SCIR; all other variables take the standard Langevin update.

    Generic over any model whose parameters store a `logit_pi` slot and
    whose `windowed_marginal_gradient`/`grad_logprior` accept
    ``use_scir`` (GaussHMM and ARPHMM, like the reference mixin).
    """

    def sample_sgld_scir(self, epsilon, **kwargs):
        from ..ops import hmm as hmm_ops
        m = self.model
        cfg = self._score_config(**kwargs)
        T = self.T
        cache_key = ("sgld_scir", cfg, float(epsilon))
        if cache_key not in self._cache:
            S = cfg.subsequence_length
            full = (S == -1) or (S >= T)
            B = 0 if full else (T if cfg.buffer_length == -1
                                else max(cfg.buffer_length, 0))
            S_eff = T if full else S
            score = sgmcmc.make_marginal_score_fn(
                lambda p, w, v, wt: m.windowed_marginal_gradient(
                    p, w, v, wt, B, S_eff, use_scir=True), cfg, T)
            prior = self.prior

            def step(key, params, obs):
                k_grad, k_scir, k_noise = jax.random.split(key, 3)
                grad_ll, ll = score(k_grad, params, obs)
                grad = sgmcmc.tree_add(
                    grad_ll, m.grad_logprior(prior, params, use_scir=True))
                a = grad.logit_pi          # unscaled Dirichlet suff stats
                theta = jnp.exp(params.logit_pi)
                theta_new = hmm_ops.scir_update(k_scir, theta, a, epsilon)
                new_logit = jnp.log(jnp.abs(theta_new) + 1e-99)
                new_logit = new_logit - jnp.mean(new_logit, axis=1,
                                                 keepdims=True)
                scale = 1.0 / T
                noise = sgmcmc.tree_random_normal(k_noise, params, scale)
                upd = jax.tree_util.tree_map(
                    lambda p, g, n: p + epsilon * g * scale
                    + jnp.sqrt(2.0 * epsilon) * n, params, grad, noise)
                new = upd.replace(logit_pi=new_logit)
                return m.project_parameters(new, center_logit=False), ll

            self._cache[cache_key] = jax.jit(step)
        self.parameters, _ = self._cache[cache_key](
            self.next_key(), self.parameters, self.observations)
        return self.parameters


class GaussHMMSampler(GibbsSamplerMixin, SCIRSamplerMixin, Sampler):
    def __init__(self, observations=None, num_states=2, m=1, **kw):
        from ..models.registry import get_model
        super().__init__(get_model("gauss_hmm", num_states=num_states, m=m),
                         observations, **kw)


class ARPHMMSampler(GibbsSamplerMixin, SCIRSamplerMixin, Sampler):
    def __init__(self, observations=None, num_states=2, m=1, p=1, **kw):
        from ..models.registry import get_model
        super().__init__(get_model("arphmm", num_states=num_states, m=m,
                                   p=p), observations, **kw)


def sampler_for_model(model_name: str, **kwargs):
    """Model-name -> concrete sampler instance (the single dispatch point
    generic code uses, keeping the Gibbs/SCIR mixin wiring next to the
    sampler classes rather than duplicated in callers)."""
    classes = {"svm": SVMSampler, "svjm": SVJMSampler,
               "garch": GARCHSampler, "lgssm": LGSSMSampler,
               "gauss_hmm": GaussHMMSampler, "arphmm": ARPHMMSampler,
               "slds": SLDSSampler}
    if model_name not in classes:
        raise ValueError(f"Unknown model '{model_name}' "
                         f"(choose from {sorted(classes)})")
    return classes[model_name](**kwargs)
