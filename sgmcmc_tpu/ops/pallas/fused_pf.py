"""Fully-fused buffered particle smoother window — one Pallas kernel.

Fusion of the whole `pf_wrapper` hot loop
(`/root/reference/sgmcmc_ssm/particle_filters/buffered_smoother.py:93-133`
with the Nemeth/Poyiadjis-O(N) step `pf.py:138-181`): all W window steps —
weight normalization + CDF, systematic resampling, proposal, reweighting,
additive-statistic update and the log-likelihood accumulator — run inside
one kernel, written for the GPU through Pallas' Triton route.

Layout: one program per chain; the chain's N particles (a power of two)
are one block.  Particles, log-weights and statistics stay in registers
across the W steps.  Resampling is the only cross-particle data movement:
each step writes the normalized CDF and the carried values to a per-chain
scratch row (L1/L2-resident), finds every ancestor of the sorted
systematic comb by a branch-free binary search against that CDF, and
fetches the resampled values with gathered loads.  A block barrier orders
the scratch writes against the gathers.  Selections follow the plain
gather path (`resampling.systematic_resampling`: ``searchsorted(cdf, pos,
'left')``); only the CDF's summation order differs.

The model plugs in through :class:`FusedModel` — shape-polymorphic
elementwise functions over lists of per-state-dimension arrays, so one
kernel serves every scalar-observation model family.  Randomness (x0, the
per-step proposal normals and systematic offsets) is pre-drawn outside
with `jax.random`, keeping the estimator deterministic in the key.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton


@dataclasses.dataclass(frozen=True)
class FusedModel:
    """Model bundle for the fused window kernel.

    All callables are elementwise and shape-polymorphic: state/statistic
    arrays arrive as lists of arrays of identical (arbitrary) shape, and
    parameters as a list of scalars (one per entry of ``pack_params``).

    * ``pack_params(params) -> [P]`` flattens the parameter pytree.
    * ``propose(pvec, z, x, y) -> x'`` — ``z``/``x``/``x'`` lists of D arrays.
    * ``reweight(pvec, x, x', y) -> log_w`` — one array.
    * ``stat(pvec, x, x', y) -> h`` — list of H arrays (additive statistic).
    * ``init(z, prior_mean, prior_var) -> x0`` — optional initial state
      from Z standard-normal arrays (default: every dim Gaussian from the
      first D).
    * ``n_state`` = D (dims carried and re-gathered through resampling),
      ``n_stat`` = H, ``n_noise`` = Z (standard normals consumed per step;
      defaults to D).  Decoupling them matters both ways: SVJM carries one
      state dim but needs two normals (the second is thresholded into the
      jump indicator), GARCH carries two dims (x, sigma^2) but consumes
      one normal (sigma^2 is deterministic).
    """
    n_state: int
    n_stat: int
    n_param: int
    pack_params: Callable
    propose: Callable
    reweight: Callable
    stat: Callable
    init: Callable | None = None
    n_noise: int | None = None

    @property
    def noise_dims(self) -> int:
        return self.n_state if self.n_noise is None else self.n_noise

    def __hash__(self):
        return hash((self.n_state, self.n_stat, self.n_param,
                     self.pack_params, self.propose, self.reweight,
                     self.stat, self.init, self.n_noise))


def supports_particles(n_particles: int) -> bool:
    """The kernel holds a chain's particles as one power-of-two block."""
    return n_particles >= 16 and n_particles & (n_particles - 1) == 0


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _num_warps(n_particles: int) -> int:
    """Eight particles per thread at N=1024 (4 warps), clamped to [1, 8]."""
    return max(1, min(8, n_particles // 256))


def _normalize(logw):
    """(shift, un-normalized weights, total) of a log-weight block."""
    m = jnp.max(logw)
    mf = jnp.where(jnp.isfinite(m), m, 0.0)
    w = jnp.exp(logw - mf)
    return mf, w, jnp.sum(w)


def _window_kernel(model: FusedModel, W: int, N: int, lambduh: float,
                   ess_threshold: float | None, valid_gate: bool,
                   interpret: bool,
                   pvec_ref,      # [C, P]
                   x0_ref,        # [C, D, N]
                   normals_ref,   # [C, W, Z, N]
                   aux_ref,       # [C, 4, W]: rows y_t | w_t | xi_t | v_t
                   out_ref,       # [C, NO]: H statistics, loglik, padding
                   scratch_ref):  # [C, K+1, N]: carried values, then CDF
    D, H, Z = model.n_state, model.n_stat, model.noise_dims
    K = D + H
    c = pl.program_id(0)
    fdt = jnp.float32
    jf = jax.lax.broadcasted_iota(jnp.int32, (N,), 0).astype(fdt)
    log_n = jnp.log(float(N))
    pv = [pvec_ref[c, i] for i in range(model.n_param)]

    def barrier():
        # block-wide: orders this chain's scratch writes against the
        # gathered loads (the interpreter runs one program serially)
        if not interpret:
            pltriton.debug_barrier()

    def write_carry(V):
        for k in range(K):
            scratch_ref[c, k, :] = V[k]

    def step(t, carry):
        V, logw, ll = carry
        y_t = aux_ref[c, 0, t]
        w_t = aux_ref[c, 1, t]
        xi_t = aux_ref[c, 2, t]

        mf, w, tot = _normalize(logw)
        ok = tot > 0
        # deferred loglik increment of the previous step's new weights
        # (`buffered_smoother.py:124`): logw here IS that step's logw_new,
        # and mf/tot are the reduces the increment needs.
        w_prev = jnp.where(t > 0, aux_ref[c, 1, jnp.maximum(t - 1, 0)], 0.0)
        inc = mf + jnp.log(jnp.where(ok, tot, 1.0)) - log_n
        ll = ll + jnp.where(w_prev != 0, w_prev * jnp.where(ok, inc, -jnp.inf),
                            0.0)
        probs = jnp.where(ok, w / jnp.where(ok, tot, 1.0), 1.0 / N)
        if lambduh != 1.0:
            S_bar = [jnp.sum(V[D + h] * probs) for h in range(H)]

        # ---- systematic resampling: CDF -> ancestors -> gathered values
        scratch_ref[c, K, :] = jnp.cumsum(probs)
        barrier()
        pos = (jf + xi_t) / N
        idx = jnp.zeros((N,), jnp.int32)
        half = N // 2
        while half >= 1:          # idx = min(#{j: cdf_j < pos}, N - 1)
            probe = pltriton.load(scratch_ref.at[c, K, idx + (half - 1)])
            idx = jnp.where(probe < pos, idx + half, idx)
            half //= 2
        Vr = [pltriton.load(scratch_ref.at[c, k, idx]) for k in range(K)]
        barrier()
        if ess_threshold is not None:
            # ESS gate: keep the particles and carry the normalized-to-
            # uniform weights when ESS >= thr * N (`smoothers._ess_gate`)
            sumsq = jnp.sum(w * w)
            ess = tot * tot / jnp.where(sumsq > 0, sumsq, 1.0)
            do_res = jnp.logical_or(ess < ess_threshold * N,
                                    jnp.logical_not(ok))
            carried = jnp.where(
                ok, logw - mf - jnp.log(jnp.where(ok, tot, 1.0)) + log_n, 0.0)
            Vr = [jnp.where(do_res, a, b) for a, b in zip(Vr, V)]

        # ---- propose / reweight / statistic update
        xr, sr = Vr[:D], Vr[D:]
        z = [normals_ref[c, t, d, :] for d in range(Z)]
        x_new = model.propose(pv, z, xr, y_t)
        logw_new = model.reweight(pv, xr, x_new, y_t)
        if ess_threshold is not None:
            logw_new = logw_new + jnp.where(do_res, 0.0, carried)
        h = model.stat(pv, xr, x_new, y_t)
        if lambduh == 1.0:
            s_new = [sr[i] + w_t * h[i] for i in range(H)]
        else:
            s_new = [lambduh * sr[i] + (1.0 - lambduh) * S_bar[i]
                     + w_t * h[i] for i in range(H)]
        V_new = list(x_new) + s_new
        if valid_gate:
            # padded-tail gate (multi-sequence full windows): freeze the
            # carries on invalid steps.  The deferred increments stay
            # right: the first invalid step still applies the last active
            # step's increment, later ones carry w == 0.
            act = aux_ref[c, 3, t] > 0
            V_new = [jnp.where(act, a, b) for a, b in zip(V_new, V)]
            logw_new = jnp.where(act, logw_new, logw)
        write_carry(V_new)
        return tuple(V_new), logw_new, ll

    V0 = tuple([x0_ref[c, d, :] for d in range(D)]
               + [jnp.zeros((N,), fdt)] * H)
    write_carry(V0)
    V, logw, ll = jax.lax.fori_loop(
        0, W, step, (V0, jnp.zeros((N,), fdt), jnp.zeros((), fdt)))

    # ---- weight-averaged final statistic (`buffered_smoother.py:151-154`)
    # + the deferred loglik increment of the last step
    mf, w, tot = _normalize(logw)
    ok = tot > 0
    w_last = aux_ref[c, 1, W - 1]
    inc = mf + jnp.log(jnp.where(ok, tot, 1.0)) - log_n
    ll = ll + jnp.where(w_last != 0, w_last * jnp.where(ok, inc, -jnp.inf),
                        0.0)
    probs = jnp.where(ok, w / jnp.where(ok, tot, 1.0), 1.0 / N)
    cols = [jnp.sum(V[D + h] * probs) for h in range(H)] + [ll]
    NO = out_ref.shape[1]
    slot = jax.lax.broadcasted_iota(jnp.int32, (NO,), 0)
    row = jnp.zeros((NO,), fdt)
    for i, v in enumerate(cols):
        row = jnp.where(slot == i, v, row)
    out_ref[c, :] = row


@functools.partial(jax.jit, static_argnames=(
    "model", "lambduh", "interpret", "ess_threshold", "valid_gate"))
def fused_window_batched(model: FusedModel,
                         pvec: jax.Array,      # [C, P]
                         x0: jax.Array,        # [C, D, N]
                         normals: jax.Array,   # [C, W, Z, N]
                         ys: jax.Array,        # [C, W]
                         weights: jax.Array,   # [C, W]
                         xi: jax.Array,        # [C, W]
                         lambduh: float = 1.0,
                         interpret: bool = False,
                         ess_threshold: float | None = None,
                         vs: jax.Array | None = None,   # [C, W] validity
                         valid_gate: bool = False):
    """Run the fused window for a batch of chains, one program per chain.

    Returns (mean_statistic [C, H], loglikelihood [C]).
    """
    C, W = ys.shape
    N = x0.shape[-1]
    if not supports_particles(N):
        raise ValueError(f"fused window kernel needs a power-of-two particle "
                         f"count >= 16, got {N}")
    D, H = model.n_state, model.n_stat
    fdt = jnp.float32
    if vs is None:
        vs = jnp.ones_like(ys)
    aux = jnp.stack([ys, weights, xi, vs], axis=1).astype(fdt)   # [C, 4, W]
    NO = _next_pow2(H + 1)
    out, _ = pl.pallas_call(
        functools.partial(_window_kernel, model, W, N, float(lambduh),
                          ess_threshold, valid_gate, interpret),
        grid=(C,),
        out_shape=[jax.ShapeDtypeStruct((C, NO), fdt),
                   jax.ShapeDtypeStruct((C, D + H + 1, N), fdt)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=_num_warps(N), num_stages=1),
        interpret=interpret,
        name="fused_pf_window",
    )(pvec.astype(fdt), x0.astype(fdt), normals.astype(fdt), aux)
    return out[:, :H], out[:, H]


def _bc(x, batched, n):
    return x if batched else jnp.broadcast_to(x, (n,) + x.shape)


@functools.lru_cache(maxsize=None)
def _fused_callable(model: FusedModel, lambduh: float, interpret: bool,
                    ess_threshold: float | None, valid_gate: bool):
    """Single-chain fused call whose vmap collapses into real chain
    batches (nested vmaps flatten)."""
    kw = dict(lambduh=lambduh, interpret=interpret,
              ess_threshold=ess_threshold, valid_gate=valid_gate)

    @jax.custom_batching.custom_vmap
    def flat(pvec, x0, normals, ys, weights, xi, vs):
        return fused_window_batched(model, pvec, x0, normals, ys, weights,
                                    xi, vs=vs, **kw)

    @flat.def_vmap
    def flat_vmap(axis_size, in_batched, *args):
        args = [_bc(a, b, axis_size) for a, b in zip(args, in_batched)]
        C2, C1 = args[0].shape[:2]
        out = flat(*[a.reshape((C2 * C1,) + a.shape[2:]) for a in args])
        return (out[0].reshape((C2, C1) + out[0].shape[1:]),
                out[1].reshape(C2, C1)), (True, True)

    @jax.custom_batching.custom_vmap
    def single(pvec, x0, normals, ys, weights, xi, vs):
        ms, ll = flat(pvec[None], x0[None], normals[None], ys[None],
                      weights[None], xi[None], vs[None])
        return ms[0], ll[0]

    @single.def_vmap
    def single_vmap(axis_size, in_batched, *args):
        args = [_bc(a, b, axis_size) for a, b in zip(args, in_batched)]
        return flat(*args), (True, True)

    return single


def fused_pf_score(model: FusedModel, key, params, window, step_weights,
                   n_particles: int, prior_mean, prior_var,
                   lambduh: float = 1.0, interpret: bool = False,
                   ess_threshold: float | None = None, step_valid=None):
    """Single-chain fused buffered-PF score: (mean_stat [H], loglik).

    Draws x0, per-step proposal normals, and systematic offsets from
    ``key``, then runs the fused kernel; under vmap, chains collapse into
    one kernel batch.  ``interpret`` runs the Pallas interpreter (tests
    on the CPU); user paths get it from `ops.dispatch`.
    """
    N = n_particles
    W = window.shape[0]
    D = model.n_state
    Z = model.noise_dims
    # scalar-state prior moments may arrive as [1] / [1, 1] arrays
    prior_mean = jnp.asarray(prior_mean, jnp.float32).reshape(-1)[0]
    prior_var = jnp.asarray(prior_var, jnp.float32).reshape(-1)[0]
    k0, kz, kxi = jax.random.split(key, 3)
    z0 = jax.random.normal(k0, (Z, N), jnp.float32)
    if model.init is None:
        x0 = prior_mean + jnp.sqrt(prior_var) * z0[:D]
    else:
        x0 = jnp.stack(model.init(list(z0), prior_mean, prior_var))
    normals = jax.random.normal(kz, (W, Z, N), jnp.float32)
    xi = jax.random.uniform(kxi, (W,), jnp.float32)
    pvec = model.pack_params(params).astype(jnp.float32).reshape(-1)
    ys = window.reshape(W).astype(jnp.float32)
    vs = (jnp.ones((W,), jnp.float32) if step_valid is None
          else step_valid.astype(jnp.float32))
    fn = _fused_callable(model, float(lambduh), bool(interpret),
                         None if ess_threshold is None
                         else float(ess_threshold), step_valid is not None)
    return fn(pvec, x0, normals, ys, step_weights.astype(jnp.float32), xi,
              vs)
