"""Numeric linear-algebra utilities (accelerator-first JAX rewrites).

Functional equivalents of the reference's LAPACK-backed helpers
(`/root/reference/sgmcmc_ssm/_utils.py:88-183`), reimplemented on top of
XLA-lowered primitives (Cholesky, triangular solve, SVD) so they jit, vmap,
and differentiate.  All functions are pure and dtype-polymorphic.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def tril_dim(n: int) -> int:
    """Number of entries in the lower triangle of an (n, n) matrix."""
    return (n * (n + 1)) // 2


def tril_n_from_dim(d: int) -> int:
    """Inverse of :func:`tril_dim`: matrix size n with n(n+1)/2 == d."""
    n = int((np.sqrt(8 * d + 1) - 1) / 2)
    if tril_dim(n) != d:
        raise ValueError(f"{d} is not a triangular number")
    return n


def tril_vector_to_mat(vec: jax.Array) -> jax.Array:
    """Expand a packed lower-triangle vector into an (n, n) lower-tri matrix.

    Row-major packing over the lower triangle, matching
    ``LQinv[np.tril_indices_from(LQinv)]`` in the reference
    (`_utils.py:135-147`).
    """
    d = vec.shape[-1]
    n = tril_n_from_dim(d)
    rows, cols = np.tril_indices(n)
    mat = jnp.zeros(vec.shape[:-1] + (n, n), dtype=vec.dtype)
    return mat.at[..., rows, cols].set(vec)


def mat_to_tril_vector(mat: jax.Array) -> jax.Array:
    """Pack the lower triangle of an (n, n) matrix row-major into a vector."""
    n = mat.shape[-1]
    rows, cols = np.tril_indices(n)
    return mat[..., rows, cols]


def sym(mat: jax.Array) -> jax.Array:
    """Symmetrize a square matrix."""
    return 0.5 * (mat + jnp.swapaxes(mat, -1, -2))


def pos_def_mat_inv(mat: jax.Array) -> jax.Array:
    """Inverse of a positive-definite matrix via Cholesky.

    Batched replacement for the reference's dpotrf/dpotri path
    (`_utils.py:88-107`).
    """
    L = jnp.linalg.cholesky(mat)
    eye = jnp.eye(mat.shape[-1], dtype=mat.dtype)
    Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    return jnp.swapaxes(Linv, -1, -2) @ Linv


def pos_def_log_det(mat: jax.Array) -> jax.Array:
    """log|M| for positive-definite M via Cholesky (`_utils.py:108-121`)."""
    L = jnp.linalg.cholesky(mat)
    diag = jnp.diagonal(L, axis1=-2, axis2=-1)
    return 2.0 * jnp.sum(jnp.log(diag), axis=-1)


def lower_tri_mat_inv(L: jax.Array) -> jax.Array:
    """Inverse of a lower-triangular matrix (`_utils.py:122-134`)."""
    eye = jnp.eye(L.shape[-1], dtype=L.dtype)
    return jax.scipy.linalg.solve_triangular(L, eye, lower=True)


def spectral_norm_projection(A: jax.Array, threshold: float = 0.9999) -> jax.Array:
    """Project a square matrix to spectral norm <= threshold.

    Accelerator replacement for the reference's VAR(p) stability projection
    (`_utils.py:149-172`), which clips *eigenvalues* of the companion matrix.
    Non-symmetric eigendecomposition has no accelerator lowering in XLA, so
    we instead shrink by the largest singular value: since
    rho(A) <= sigma_max(A), sigma_max <= threshold implies the spectral
    radius is below threshold
    (a slightly stronger projection; identical for scalars and symmetric A).
    """
    if A.shape[-1] == 1:
        return jnp.clip(A, -threshold, threshold)
    s_max = jnp.linalg.norm(A, ord=2, axis=(-2, -1)) if A.ndim == 2 else (
        jnp.linalg.svd(A, compute_uv=False)[..., 0])
    scale = jnp.minimum(1.0, threshold / jnp.maximum(s_max, 1e-30))
    return A * scale


def var_stationary_precision(Qinv: jax.Array, A: jax.Array,
                             num_iters: int = 10) -> jax.Array:
    """Approximate stationary precision of x' = A x + N(0, Q).

    Iterates the covariance fixed point Sigma <- A Sigma A^T + Q for
    ``num_iters`` steps starting from Q and inverts, matching the reference's
    truncated series (`_utils.py:175-183`).
    """
    Q = pos_def_mat_inv(Qinv)

    def body(_, sigma):
        return A @ sigma @ A.T + Q

    sigma = jax.lax.fori_loop(1, num_iters, body, Q)
    return pos_def_mat_inv(sym(sigma))
