"""Parallel-in-time Kalman filtering/smoothing via associative scans.

Time-axis parallelization of the LGSSM oracle: the reference's
sequential per-timestep filter loop (`lgssm/helper.py:53-122`) is
re-derived as an *associative* operation on Gaussian conditionals, so
`jax.lax.associative_scan` evaluates every filtered (and smoothed)
moment in O(log T) depth instead of O(T) (Särkkä & García-Fernández,
"Temporal Parallelization of Bayesian Smoothers", IEEE TAC 2021).

This is the SURVEY §2.4 "sequence/time axis" component: the buffered
SG-MCMC estimators never need it (their windows are short), but the
full-data passes — the exact-gradient oracle, LD baselines, KSD
full-trace scores, offline evaluation — run over the whole series, where
log-depth wins on an accelerator once T is large.

Filtering elements are 5-tuples (A, b, C, eta, J) representing
p(x_t | x_{t-1}, y_cond) ∝ N(x_t; A x_{t-1} + b, C) x exp(eta·x_{t-1}
- ½ x_{t-1}ᵀ J x_{t-1}); smoothing elements are (E, g, L) affine
Gaussian conditionals combined right-to-left.  All combinators operate
on stacked [T, ...] operands (batched matmuls/solves).

Conventions match `ops/kalman.py`: model x_t = A x_{t-1} + N(0, Q),
y_t = C_emit x_t + N(0, R); the prior message is information-form
(mean_precision h0, precision J0), i.e. x_0's *predictive* distribution
before the first observation is N(inv(J0) h0, inv(J0)) propagated through
one transition.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .kalman import GaussianMessage, init_forward_message

_LOG_2PI = float(np.log(2.0 * np.pi))


class FilterMoments(NamedTuple):
    mean: jax.Array          # [T, n] filtered means  E[x_t | y_{<=t}]
    cov: jax.Array           # [T, n, n] filtered covariances
    pred_mean: jax.Array     # [T, n] predicted means E[x_t | y_{<t}]
    pred_cov: jax.Array      # [T, n, n]


def _filter_combine(e1, e2):
    """Associative combination of filtering elements (Lemma 8)."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    n = A1.shape[-1]
    eye = jnp.eye(n, dtype=A1.dtype)
    IC = eye + C1 @ J2                       # [.., n, n]
    ICt = eye + J2 @ C1
    A = A2 @ jnp.linalg.solve(IC, A1)
    b = (A2 @ jnp.linalg.solve(IC, (b1 + (C1 @ eta2[..., None])[..., 0])
                               [..., None]))[..., 0] + b2
    C = A2 @ jnp.linalg.solve(IC, C1) @ jnp.swapaxes(A2, -1, -2) + C2
    eta_in = eta2 - (J2 @ b1[..., None])[..., 0]
    eta = (jnp.swapaxes(A1, -1, -2) @ jnp.linalg.solve(
        ICt, eta_in[..., None]))[..., 0] + eta1
    J = (jnp.swapaxes(A1, -1, -2) @ jnp.linalg.solve(ICt, J2) @ A1) + J1
    J = 0.5 * (J + jnp.swapaxes(J, -1, -2))
    C = 0.5 * (C + jnp.swapaxes(C, -1, -2))
    return (A, b, C, eta, J)


def _filter_elements(observations, A, C_emit, Q, R, m0, P0):
    """Per-step filtering elements; element 0 absorbs the prior."""
    T = observations.shape[0]
    n = A.shape[0]
    dtype = observations.dtype
    eye = jnp.eye(n, dtype=dtype)

    # generic elements (t >= 1)
    S = C_emit @ Q @ C_emit.T + R                       # [m, m]
    K = jnp.linalg.solve(S, C_emit @ Q).T               # Q Cᵀ S⁻¹  [n, m]
    ImKC = eye - K @ C_emit
    A_g = ImKC @ A
    C_g = ImKC @ Q
    CtSinv = jnp.linalg.solve(S, C_emit).T              # Cᵀ S⁻¹  [n, m]
    b_all = (observations @ K.T)                        # [T, n]
    eta_all = observations @ (A.T @ CtSinv).T           # [T, n]
    J_g = A.T @ CtSinv @ C_emit @ A

    # first element absorbs the prior predictive N(A m0, A P0 Aᵀ + Q)
    m1 = A @ m0
    P1 = A @ P0 @ A.T + Q
    S1 = C_emit @ P1 @ C_emit.T + R
    K1 = jnp.linalg.solve(S1, C_emit @ P1).T
    b0 = m1 + K1 @ (observations[0] - C_emit @ m1)
    C0 = (eye - K1 @ C_emit) @ P1
    C0 = 0.5 * (C0 + C0.T)

    A_el = jnp.concatenate([jnp.zeros((1, n, n), dtype),
                            jnp.broadcast_to(A_g, (T - 1, n, n))])
    b_el = jnp.concatenate([b0[None], b_all[1:]])
    C_el = jnp.concatenate([C0[None],
                            jnp.broadcast_to(C_g, (T - 1, n, n))])
    eta_el = jnp.concatenate([jnp.zeros((1, n), dtype), eta_all[1:]])
    J_el = jnp.concatenate([jnp.zeros((1, n, n), dtype),
                            jnp.broadcast_to(J_g, (T - 1, n, n))])
    return (A_el, b_el, C_el, eta_el, J_el), (m1, P1)


def _prior_moments(A, forward_msg: GaussianMessage):
    n = A.shape[0]
    J0 = forward_msg.precision
    m0 = jnp.linalg.solve(J0, forward_msg.mean_precision)
    P0 = jnp.linalg.inv(J0)
    return m0, P0


def parallel_filtered_moments(observations, A, C_emit, LQinv, LRinv,
                              forward_msg: GaussianMessage | None = None
                              ) -> FilterMoments:
    """All filtered and one-step-predicted moments in O(log T) depth.

    Matches `kalman.filtered_moments` / the information filter
    (`lgssm/helper.py:53-122`, `:558-648`) to numerical precision.
    """
    n = A.shape[0]
    dtype = observations.dtype
    if forward_msg is None:
        forward_msg = init_forward_message(n, dtype)
    LQi = jnp.linalg.inv(LQinv)
    Q = LQi.T @ LQi                         # inv(LQinv LQinvᵀ)
    LRi = jnp.linalg.inv(LRinv)
    R = LRi.T @ LRi
    m0, P0 = _prior_moments(A, forward_msg)
    elements, (m1, P1) = _filter_elements(observations, A, C_emit, Q, R,
                                          m0, P0)
    _, b, C, _, _ = jax.lax.associative_scan(_filter_combine, elements)
    # predicted moments, vectorized from the filtered ones
    pred_mean = jnp.concatenate([m1[None], b[:-1] @ A.T])
    pred_cov = jnp.concatenate(
        [P1[None], A @ C[:-1] @ A.T + Q])
    return FilterMoments(mean=b, cov=C, pred_mean=pred_mean,
                         pred_cov=pred_cov)


def parallel_marginal_loglikelihood(observations, A, C_emit, LQinv, LRinv,
                                    forward_msg: GaussianMessage | None =
                                    None) -> jax.Array:
    """log p(y_{1:T}) = sum_t log N(y_t; C m_{t|t-1}, C P_{t|t-1} Cᵀ + R),
    with the predictive moments from the parallel filter (all T
    normalizers evaluated at once)."""
    fm = parallel_filtered_moments(observations, A, C_emit, LQinv, LRinv,
                                   forward_msg)
    LRi = jnp.linalg.inv(LRinv)
    R = LRi.T @ LRi
    y_mean = fm.pred_mean @ C_emit.T                       # [T, m]
    S = C_emit @ fm.pred_cov @ C_emit.T + R                # [T, m, m]
    diff = observations - y_mean
    sol = jnp.linalg.solve(S, diff[..., None])[..., 0]
    m = observations.shape[1]
    _, logdet = jnp.linalg.slogdet(S)
    return jnp.sum(-0.5 * jnp.sum(diff * sol, axis=-1)
                   - 0.5 * logdet - 0.5 * m * _LOG_2PI)


def _smoother_combine(a, b):
    """Associative combination of RTS smoothing elements (Lemma 10).

    Under ``associative_scan(..., reverse=True)`` the operands arrive in
    *flipped* order — ``a`` is the already-combined suffix (later in
    time), ``b`` the earlier element — so the earlier element's gain
    left-multiplies: result_t = E_t · suffix + g_t."""
    E_a, g_a, L_a = a
    E_b, g_b, L_b = b
    E = E_b @ E_a
    g = g_b + (E_b @ g_a[..., None])[..., 0]
    L = E_b @ L_a @ jnp.swapaxes(E_b, -1, -2) + L_b
    L = 0.5 * (L + jnp.swapaxes(L, -1, -2))
    return (E, g, L)


def parallel_smoothed_moments(observations, A, C_emit, LQinv, LRinv,
                              forward_msg: GaussianMessage | None = None):
    """All smoothed moments E[x_t | y_{1:T}], Cov[x_t | y_{1:T}] in
    O(log T) depth: parallel filter + a reverse associative scan over RTS
    gain elements.  Matches `lgssm.latent_var_distr` (smoothed mode)."""
    fm = parallel_filtered_moments(observations, A, C_emit, LQinv, LRinv,
                                   forward_msg)
    n = A.shape[0]
    dtype = observations.dtype
    LQi = jnp.linalg.inv(LQinv)
    Q = LQi.T @ LQi
    # E_t = P_t Aᵀ inv(A P_t Aᵀ + Q), for t < T-1 relative to t+1
    P = fm.cov
    Ppred_next = A @ P @ A.T + Q                          # [T, n, n]
    E = jnp.swapaxes(jnp.linalg.solve(
        Ppred_next, A @ P), -1, -2)                       # [T, n, n]
    g = fm.mean - (E @ (fm.mean @ A.T)[..., None])[..., 0]
    L = P - E @ Ppred_next @ jnp.swapaxes(E, -1, -2)
    # terminal element: identity conditional on the last filtered moment
    E = E.at[-1].set(jnp.zeros((n, n), dtype))
    g = g.at[-1].set(fm.mean[-1])
    L = L.at[-1].set(fm.cov[-1])
    E_s, g_s, L_s = jax.lax.associative_scan(_smoother_combine, (E, g, L),
                                             reverse=True)
    L_s = 0.5 * (L_s + jnp.swapaxes(L_s, -1, -2))
    return g_s, L_s
