"""Exact Kalman message passing in information form, as `lax.scan`.

The LGSSM correctness oracle: forward/backward messages, marginal
log-likelihood, and the Fisher-identity gradient via pairwise smoothed
moments — functional rewrites of the reference's per-timestep loops
(`/root/reference/sgmcmc_ssm/models/lgssm/helper.py:53-420`).

Messages are Gaussian potentials in information form
``exp(-0.5 x^T J x + h^T x) * exp(log_c)`` with ``h = mean_precision``,
``J = precision`` (`lgssm/helper.py:17-29`).

Design deltas from the reference (intentional, accelerator-first):
  * the T-loop is a `lax.scan`; all-t message stacks come out of the scan,
  * the gradient assembles per-step contributions with batched solves and
    einsums over the stacked messages instead of a Python loop,
  * everything is dtype-polymorphic; run in float64 on CPU for oracle use.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_LOG_2PI = float(np.log(2.0 * np.pi))


class GaussianMessage(NamedTuple):
    log_constant: jax.Array    # scalar
    mean_precision: jax.Array  # [n]
    precision: jax.Array       # [n, n]


def init_forward_message(n: int, dtype=jnp.float64,
                         precision_scale: float = 0.1) -> GaussianMessage:
    """Default diffuse prior message (`lgssm/helper.py:35-41`)."""
    return GaussianMessage(jnp.zeros((), dtype), jnp.zeros((n,), dtype),
                           jnp.eye(n, dtype=dtype) * precision_scale)


def init_backward_message(n: int, dtype=jnp.float64) -> GaussianMessage:
    """Default trivial likelihood message (`lgssm/helper.py:43-48`)."""
    return GaussianMessage(jnp.zeros((), dtype), jnp.zeros((n,), dtype),
                           jnp.zeros((n, n), dtype))


def _mats(A, C, LQinv, LRinv):
    Qinv = LQinv @ LQinv.T
    Rinv = LRinv @ LRinv.T
    return Qinv, Rinv, A.T @ Qinv, C.T @ Rinv


def forward_messages(observations, A, C, LQinv, LRinv,
                     forward_message: GaussianMessage,
                     weights=None, valid=None):
    """All filtered messages p(x_t | y_{<=t}) for t = -1..T-1.

    Returns a GaussianMessage pytree with leading axis T+1 (element 0 is the
    input message), matching `_forward_messages`
    (`lgssm/helper.py:53-122`).  ``valid`` (float {0,1} per step) gates the
    whole update — invalid steps pass the message through unchanged,
    enabling fixed-shape buffered windows clipped at sequence edges.
    """
    T = observations.shape[0]
    dtype = observations.dtype
    Qinv, Rinv, AtQinv, CtRinv = _mats(A, C, LQinv, LRinv)
    AtQinvA = AtQinv @ A
    CtRinvC = CtRinv @ C
    m = C.shape[0]
    if weights is None:
        weights = jnp.ones((T,), dtype)
    if valid is None:
        valid = jnp.ones((T,), dtype)

    def step(carry, inp):
        h, J = carry
        y, w, v = inp
        # Predict
        K = jnp.linalg.solve(AtQinvA + J, AtQinv)
        h_pred = K.T @ h
        J_pred = Qinv - AtQinv.T @ K
        # Observation log-normalizer
        y_mean = C @ jnp.linalg.solve(J_pred, h_pred)
        y_prec = Rinv - CtRinv.T @ jnp.linalg.solve(CtRinvC + J_pred, CtRinv)
        diff = y - y_mean
        log_c = (-0.5 * diff @ (y_prec @ diff)
                 + 0.5 * jnp.linalg.slogdet(y_prec)[1]
                 - 0.5 * m * _LOG_2PI)
        # Update
        h_new = v * (h_pred + CtRinv @ y) + (1.0 - v) * h
        J_new = v * (J_pred + CtRinvC) + (1.0 - v) * J
        return (h_new, J_new), (v * w * log_c, h_new, J_new)

    (_, _), (log_cs, hs, Js) = jax.lax.scan(
        step, (forward_message.mean_precision, forward_message.precision),
        (observations, weights, valid))

    log_constants = forward_message.log_constant + jnp.concatenate(
        [jnp.zeros((1,), dtype), jnp.cumsum(log_cs)])
    hs = jnp.concatenate([forward_message.mean_precision[None], hs])
    Js = jnp.concatenate([forward_message.precision[None], Js])
    return GaussianMessage(log_constants, hs, Js)


def forward_message(observations, A, C, LQinv, LRinv,
                    forward_message: GaussianMessage, weights=None,
                    valid=None):
    """Only the final filtered message (only_return_last=True path)."""
    msgs = forward_messages(observations, A, C, LQinv, LRinv,
                            forward_message, weights, valid)
    return GaussianMessage(msgs.log_constant[-1], msgs.mean_precision[-1],
                           msgs.precision[-1])


def backward_messages(observations, A, C, LQinv, LRinv,
                      backward_message: GaussianMessage,
                      weights=None, valid=None):
    """All likelihood messages p(y_{>t} | x_t) for t = -1..T-1.

    Element [t] conditions on observations t..T-1 (index convention of
    `_backward_messages`, `lgssm/helper.py:124-192`: output [t] has
    consumed y_t..y_{T-1}; element [T] is the input message).  ``valid``
    gates steps as in :func:`forward_messages`.
    """
    T = observations.shape[0]
    dtype = observations.dtype
    Qinv, Rinv, AtQinv, CtRinv = _mats(A, C, LQinv, LRinv)
    AtQinvA = AtQinv @ A
    CtRinvC = CtRinv @ C
    m = C.shape[0]
    half_logdet_R = jnp.sum(jnp.log(jnp.abs(jnp.diag(LRinv))))
    half_logdet_Q = jnp.sum(jnp.log(jnp.abs(jnp.diag(LQinv))))
    if weights is None:
        weights = jnp.ones((T,), dtype)
    if valid is None:
        valid = jnp.ones((T,), dtype)

    def step(carry, inp):
        h, J = carry
        y, w, vld = inp
        xi = Qinv + J + CtRinvC
        L = jnp.linalg.solve(xi, AtQinv.T)
        v = h + CtRinv @ y
        log_c = (-0.5 * m * _LOG_2PI + half_logdet_R + half_logdet_Q
                 - 0.5 * jnp.linalg.slogdet(xi)[1]
                 - 0.5 * y @ (Rinv @ y)
                 + 0.5 * v @ jnp.linalg.solve(xi, v))
        h_new = vld * (L.T @ v) + (1.0 - vld) * h
        J_new = vld * (AtQinvA - AtQinv @ L) + (1.0 - vld) * J
        return (h_new, J_new), (vld * w * log_c, h_new, J_new)

    (_, _), (log_cs, hs, Js) = jax.lax.scan(
        step, (backward_message.mean_precision, backward_message.precision),
        (observations[::-1], weights[::-1], valid[::-1]))

    # outputs are produced in reverse-time order; flip to index by t
    log_constants = backward_message.log_constant + jnp.concatenate(
        [jnp.cumsum(log_cs)[::-1], jnp.zeros((1,), dtype)])
    hs = jnp.concatenate([hs[::-1], backward_message.mean_precision[None]])
    Js = jnp.concatenate([Js[::-1], backward_message.precision[None]])
    return GaussianMessage(log_constants, hs, Js)


def backward_message(observations, A, C, LQinv, LRinv,
                     backward_message: GaussianMessage, weights=None,
                     valid=None):
    msgs = backward_messages(observations, A, C, LQinv, LRinv,
                             backward_message, weights, valid)
    return GaussianMessage(msgs.log_constant[0], msgs.mean_precision[0],
                           msgs.precision[0])


def marginal_loglikelihood(observations, A, C, LQinv, LRinv,
                           forward_msg: GaussianMessage,
                           backward_msg: GaussianMessage,
                           weights=None, valid=None):
    """Exact log p(y_{1:T}) by fusing the final forward message with the
    backward boundary message (`lgssm/helper.py:195-233`).  ``valid``
    gates steps for fixed-shape padded sequences."""
    f = forward_message(observations, A, C, LQinv, LRinv, forward_msg,
                        weights, valid)
    hf, Jf = f.mean_precision, f.precision
    hc = hf + backward_msg.mean_precision
    Jc = Jf + backward_msg.precision
    w_last = 1.0 if weights is None else weights[-1]
    return f.log_constant + w_last * (
        backward_msg.log_constant
        + 0.5 * jnp.linalg.slogdet(Jf)[1]
        - 0.5 * jnp.linalg.slogdet(Jc)[1]
        - 0.5 * hf @ jnp.linalg.solve(Jf, hf)
        + 0.5 * hc @ jnp.linalg.solve(Jc, hc))


def gradient_marginal_loglikelihood(observations, A, C, LQinv, LRinv,
                                    forward_msg: GaussianMessage,
                                    backward_msg: GaussianMessage,
                                    weights=None, include_init: bool = True,
                                    valid=None):
    """Fisher-identity gradient of log p(y) wrt (A, C, LQinv, LRinv).

    Vectorized version of `gradient_marginal_loglikelihood`
    (`lgssm/helper.py:312-420`): smoothed singleton moments drive the
    emission gradients, smoothed pairwise moments the transition gradients;
    both are batched solves + einsums over the stacked messages.

    ``valid`` (float {0,1} per step) supports fixed-shape zero-padded
    sequences: invalid steps pass messages through unchanged and carry zero
    weight in every contribution sum.

    Returns a dict {A, C, LQinv, LRinv} of *matrix* gradients; packing the
    Cholesky gradients to tril vectors is the caller's concern.
    """
    T = observations.shape[0]
    dtype = observations.dtype
    n = A.shape[0]
    if weights is None:
        weights = jnp.ones((T,), dtype)
    if valid is not None:
        weights = weights * valid

    fmsgs = forward_messages(observations, A, C, LQinv, LRinv, forward_msg,
                             valid=valid)
    bmsgs = backward_messages(observations, A, C, LQinv, LRinv, backward_msg,
                              valid=valid)

    Qinv, Rinv, AtQinv, CtRinv = _mats(A, C, LQinv, LRinv)
    QinvA = Qinv @ A
    AtQinvA = AtQinv @ A
    CtRinvC = CtRinv @ C
    RinvC = Rinv @ C
    LQinv_diaginv = jnp.diag(1.0 / jnp.diag(LQinv))
    LRinv_diaginv = jnp.diag(1.0 / jnp.diag(LRinv))

    # ---- Emission gradients: smoothed p(x_t | y) for t = 0..T-1 -----------
    hc = fmsgs.mean_precision[1:] + bmsgs.mean_precision[1:]      # [T, n]
    Jc = fmsgs.precision[1:] + bmsgs.precision[1:]                # [T, n, n]
    x_mean = jnp.linalg.solve(Jc, hc[..., None])[..., 0]          # [T, n]
    x_cov = jnp.linalg.inv(Jc)
    xxt = x_cov + x_mean[:, :, None] * x_mean[:, None, :]         # [T, n, n]

    y = observations                                              # [T, m]
    w = weights
    C_grad = (jnp.einsum('t,tm,tn->mn', w, y @ Rinv.T, x_mean)
              - RinvC @ jnp.einsum('t,tnk->nk', w, xxt))
    Cxyt = jnp.einsum('tn,tm->tnm', x_mean @ C.T, y)              # [T, m, m]
    CxxtCt = jnp.einsum('nj,tjk,mk->tnm', C, xxt, C)              # [T, m, m]
    yyt = jnp.einsum('tm,tk->tmk', y, y)
    S_emit = jnp.einsum('t,tmk->mk', w, yyt - Cxyt -
                        jnp.swapaxes(Cxyt, -1, -2) + CxxtCt)
    LRinv_grad = jnp.sum(w) * LRinv_diaginv - S_emit @ LRinv

    # ---- Transition gradients: pairwise p(x_t, x_{t+1} | y) ---------------
    # pairs (forward index t, backward index t+1, observation t); with
    # include_init the first pair couples the prior message to y_0
    # (`lgssm/helper.py:376-381`).
    if include_init:
        f_h, f_J = fmsgs.mean_precision[:-1], fmsgs.precision[:-1]
        b_h, b_J = bmsgs.mean_precision[1:], bmsgs.precision[1:]
        y_p, w_p = y, w
    else:
        f_h, f_J = fmsgs.mean_precision[1:-1], fmsgs.precision[1:-1]
        b_h, b_J = bmsgs.mean_precision[2:], bmsgs.precision[2:]
        y_p, w_p = y[1:], w[1:]

    Tp = f_h.shape[0]
    hp = jnp.concatenate([f_h, b_h + y_p @ RinvC], axis=-1)       # [Tp, 2n]
    Jp = jnp.zeros((Tp, 2 * n, 2 * n), dtype)
    Jp = Jp.at[:, :n, :n].set(f_J + AtQinvA)
    Jp = Jp.at[:, :n, n:].set(-QinvA.T)
    Jp = Jp.at[:, n:, :n].set(-QinvA)
    Jp = Jp.at[:, n:, n:].set(b_J + CtRinvC + Qinv)

    c_mean = jnp.linalg.solve(Jp, hp[..., None])[..., 0]          # [Tp, 2n]
    c_cov = jnp.linalg.inv(Jp)
    xp, xn = c_mean[:, :n], c_mean[:, n:]
    xpxpt = c_cov[:, :n, :n] + xp[:, :, None] * xp[:, None, :]
    xnxpt = c_cov[:, n:, :n] + xn[:, :, None] * xp[:, None, :]
    xnxnt = c_cov[:, n:, n:] + xn[:, :, None] * xn[:, None, :]

    sum_xpxpt = jnp.einsum('t,tij->ij', w_p, xpxpt)
    sum_xnxpt = jnp.einsum('t,tij->ij', w_p, xnxpt)
    sum_xnxnt = jnp.einsum('t,tij->ij', w_p, xnxnt)

    A_grad = Qinv @ (sum_xnxpt - A @ sum_xpxpt)
    Axpxnt = A @ sum_xnxpt.T
    S_trans = sum_xnxnt - Axpxnt - Axpxnt.T + A @ sum_xpxpt @ A.T
    LQinv_grad = jnp.sum(w_p) * LQinv_diaginv - S_trans @ LQinv

    return dict(A=A_grad, C=C_grad, LQinv=LQinv_grad, LRinv=LRinv_grad)


def pairwise_smoothed_moments(observations, A, C, LQinv, LRinv,
                              forward_msg, backward_msg):
    """Smoothed marginals p(x_t | y): (means [T, n], covs [T, n, n])."""
    fmsgs = forward_messages(observations, A, C, LQinv, LRinv, forward_msg)
    bmsgs = backward_messages(observations, A, C, LQinv, LRinv, backward_msg)
    hc = fmsgs.mean_precision[1:] + bmsgs.mean_precision[1:]
    Jc = fmsgs.precision[1:] + bmsgs.precision[1:]
    mean = jnp.linalg.solve(Jc, hc[..., None])[..., 0]
    cov = jnp.linalg.inv(Jc)
    return mean, cov


def filtered_moments(observations, A, C, LQinv, LRinv, forward_msg):
    """Filtered marginals p(x_t | y_{<=t}) for t = 0..T-1."""
    fmsgs = forward_messages(observations, A, C, LQinv, LRinv, forward_msg)
    h, J = fmsgs.mean_precision[1:], fmsgs.precision[1:]
    mean = jnp.linalg.solve(J, h[..., None])[..., 0]
    cov = jnp.linalg.inv(J)
    return mean, cov


def lagged_moments(observations, A, C, LQinv, LRinv, forward_msg,
                   backward_msg, lag: int):
    """Lagged marginals p(x_t | y_{<= t+lag}) for t = 0..T-1.

    Re-derives `latent_var_distr`'s lag modes
    (`lgssm/helper.py:558-648`): ``lag <= 0`` takes the filtered moments at
    ``t+lag`` (the prior message before the sequence start) and propagates
    ``-lag`` transition steps; ``lag > 0`` is fixed-lag smoothing — the
    filtered message at ``t`` combines with a backward message over the
    (validity-masked, fixed-shape) window ``y_{t+1 .. t+lag}``.
    """
    T = observations.shape[0]
    dtype = observations.dtype
    fmsgs = forward_messages(observations, A, C, LQinv, LRinv, forward_msg)
    if lag <= 0:
        idx = jnp.clip(jnp.arange(T) + lag + 1, 0, T)
        h = fmsgs.mean_precision[idx]
        J = fmsgs.precision[idx]
        mean = jnp.linalg.solve(J, h[..., None])[..., 0]
        cov = jnp.linalg.inv(J)
        Qinv = LQinv @ LQinv.T
        Q = jnp.linalg.inv(Qinv + 1e-16 * jnp.eye(Qinv.shape[0], dtype=dtype))
        for _ in range(-lag):
            mean = mean @ A.T
            cov = jnp.einsum('ij,tjk,lk->til', A, cov, A) + Q
        return mean, cov

    # fixed-lag: per-t backward message over y_{t+1 .. t+lag}
    idx2 = jnp.arange(T)[:, None] + 1 + jnp.arange(lag)[None, :]  # [T, lag]
    valid = (idx2 < T).astype(dtype)
    windows = jnp.take(observations, jnp.clip(idx2, 0, T - 1), axis=0)

    def back_one(win, vld):
        msg = backward_message(win, A, C, LQinv, LRinv, backward_msg,
                               valid=vld)
        return msg.mean_precision, msg.precision

    b_h, b_J = jax.vmap(back_one)(windows, valid)                 # [T, n(,n)]
    h = fmsgs.mean_precision[1:] + b_h
    J = fmsgs.precision[1:] + b_J
    mean = jnp.linalg.solve(J, h[..., None])[..., 0]
    cov = jnp.linalg.inv(J)
    return mean, cov


def ffbs_sample(key, observations, A, C, LQinv, LRinv, forward_msg,
                num_samples: int = 1, valid=None):
    """Forward-filter backward-sample of the latent path x_{0:T-1} | y.

    Rewrite of `latent_var_sample` (`lgssm/helper.py:650-732`): backward
    pass is a reverse scan; multiple joint samples vmap over the leading
    axis.  Returns [T, n] (or [num_samples, T, n] if num_samples > 1).

    ``valid`` gates rows with the same truncated-window semantics as the
    message passes: invalid rows are transparent (no transition or
    emission applied across them; their returned x is a copy of the
    neighbouring valid draw — a placeholder callers must not condition
    on).  The *last valid* row is drawn from its filtered marginal, as
    row T-1 is in the ungated case.
    """
    Qinv = LQinv @ LQinv.T
    AtQinv = A.T @ Qinv
    AtQinvA = AtQinv @ A
    fmsgs = forward_messages(observations, A, C, LQinv, LRinv, forward_msg,
                             valid=valid)
    hs, Js = fmsgs.mean_precision[1:], fmsgs.precision[1:]   # [T, n], [T,n,n]
    T, n = hs.shape[0], A.shape[0]
    dtype = observations.dtype
    v_all = (jnp.ones((T,), dtype) if valid is None
             else jnp.asarray(valid, dtype))

    def sample_one(key):
        key_last, key_rest = jax.random.split(key)
        # x at the last valid row ~ N(J^-1 h, J^-1) (pass-through messages
        # make Js[-1]/hs[-1] the last valid row's filtered message)
        L_last = jnp.linalg.cholesky(Js[-1])
        mean_last = jnp.linalg.solve(Js[-1], hs[-1])
        z = jax.random.normal(key_last, (n,), dtype)
        x_last = mean_last + jax.scipy.linalg.solve_triangular(
            L_last.T, z, lower=False)

        def step(carry, inp):
            x_next, started = carry
            h, J, v, k = inp
            Jcond = J + AtQinvA
            mean = jnp.linalg.solve(Jcond, h + AtQinv @ x_next)
            L = jnp.linalg.cholesky(Jcond)
            z = jax.random.normal(k, (n,), dtype)
            x_cond = mean + jax.scipy.linalg.solve_triangular(
                L.T, z, lower=False)
            use_cond = (v > 0) & started
            x = jnp.where(use_cond, x_cond, x_next)
            return (x, started | (v > 0)), x

        keys = jax.random.split(key_rest, T - 1)
        (_, _), xs = jax.lax.scan(step, (x_last, v_all[-1] > 0),
                                  (hs[:-1][::-1], Js[:-1][::-1],
                                   v_all[:-1][::-1], keys))
        return jnp.concatenate([xs[::-1], x_last[None]], axis=0)

    if num_samples == 1:
        return sample_one(key)
    return jax.vmap(sample_one)(jax.random.split(key, num_samples))


def predictive_loglikelihood(observations, A, C, LQinv, LRinv, forward_msg,
                             lag: int = 1):
    """Sum_t log p(y_t | y_{<= t-lag}) (`lgssm/helper.py:268-309`)."""
    T = observations.shape[0]
    m = C.shape[0]
    Q = jnp.linalg.inv(LQinv @ LQinv.T)
    R = jnp.linalg.inv(LRinv @ LRinv.T)
    obs_f = observations if lag == 0 else observations[:T - lag]
    fmsgs = forward_messages(obs_f, A, C, LQinv, LRinv, forward_msg)
    # messages indexed so fmsgs[t] = p(x_{t-1} | y_{<t}) ; for target t we
    # need p(x_{t-lag} | y_{<=t-lag}) = element (t - lag + 1)
    h = fmsgs.mean_precision[1:]
    J = fmsgs.precision[1:]
    mean = jnp.linalg.solve(J, h[..., None])[..., 0]
    cov = jnp.linalg.inv(J)

    def propagate(mc):
        mean, cov = mc
        return A @ mean, A @ cov @ A.T + Q

    def loglike_t(mean_t, cov_t, y_t):
        for _ in range(lag):
            mean_t, cov_t = propagate((mean_t, cov_t))
        y_mean = C @ mean_t
        y_var = C @ cov_t @ C.T + R
        diff = y_t - y_mean
        return (-0.5 * diff @ jnp.linalg.solve(y_var, diff)
                - 0.5 * jnp.linalg.slogdet(y_var)[1]
                - 0.5 * m * _LOG_2PI)

    if lag == 0:
        idx = jnp.arange(T)
        return jnp.sum(jax.vmap(loglike_t)(mean[idx], cov[idx],
                                           observations[idx]))
    idx = jnp.arange(T - lag)
    return jnp.sum(jax.vmap(loglike_t)(mean[idx], cov[idx],
                                       observations[idx + lag]))
