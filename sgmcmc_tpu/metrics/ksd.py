"""Kernel Stein Discrepancy with the IMQ kernel, as blocked matmuls.

JAX rewrite of `IMQ_KSD` / `compute_KSD`
(`/root/reference/sgmcmc_ssm/trace_metric_functions.py:20-112`): the O(M^2)
pairwise accumulation becomes dense Gram-matrix algebra (matmul-friendly),
blocked to bound memory for long traces.

KSD^2 = (1/M^2) sum_{i,j} [ k(xi,xj) gi.gj
                            + gi . grad_xj k + gj . grad_xi k
                            + trace_d(grad_xi grad_xj k) ]
with k(x,y) = (c^2 + ||x-y||^2)^(-beta), where g are score values
(grad log posterior) at the samples.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _stein_block(xi, gi, mi, xj, gj, mj, c2, beta):
    """Masked sum of Stein-kernel terms over one [Mi, Mj] block."""
    d = xi.shape[-1]
    diff = xi[:, None, :] - xj[None, :, :]          # [Mi, Mj, d]
    r2 = jnp.sum(diff * diff, axis=-1)
    base = c2 + r2
    k = base ** (-beta)
    kp = -beta * base ** (-beta - 1.0)              # dk/d(r2)
    kpp = beta * (beta + 1.0) * base ** (-beta - 2.0)

    gg = gi @ gj.T                                  # [Mi, Mj] (matmul)
    # grad_{xj} k = -2 kp diff,  grad_{xi} k = 2 kp diff
    t2 = -2.0 * kp * jnp.einsum('id,ijd->ij', gi, diff)
    t3 = 2.0 * kp * jnp.einsum('jd,ijd->ij', gj, diff)
    t4 = -2.0 * d * kp - 4.0 * kpp * r2
    w = mi[:, None] * mj[None, :]
    return jnp.sum(w * (k * gg + t2 + t3 + t4))


def imq_ksd(x: jax.Array, grads: jax.Array, c: float = 1.0,
            beta: float = 0.5, max_block_size: int = 512) -> jax.Array:
    """IMQ KSD of samples x [M, d] with score values grads [M, d]."""
    M, d = x.shape
    c2 = c * c
    n_blocks = max(1, -(-M // max_block_size))
    B = -(-M // n_blocks)
    pad = n_blocks * B - M
    xp = jnp.pad(x, ((0, pad), (0, 0))).reshape(n_blocks, B, d)
    gp = jnp.pad(grads, ((0, pad), (0, 0))).reshape(n_blocks, B, d)
    mp = jnp.pad(jnp.ones((M,), x.dtype), (0, pad)).reshape(n_blocks, B)

    def pair(i, j):
        return _stein_block(xp[i], gp[i], mp[i], xp[j], gp[j], mp[j],
                            c2, beta)

    ii, jj = jnp.meshgrid(jnp.arange(n_blocks), jnp.arange(n_blocks),
                          indexing="ij")
    total = jnp.sum(jax.vmap(jax.vmap(pair))(ii, jj))
    return jnp.sqrt(total) / M


def compute_ksd(param_list, grad_list, variables: list[str], c: float = 1.0,
                beta: float = 0.5, max_block_size: int = 512):
    """Per-variable KSD over a parameter trace (`compute_KSD`,
    `trace_metric_functions.py:83-112`).

    param_list/grad_list: lists of parameter pytrees and score pytrees;
    ``variables`` are attribute names to evaluate (each flattened).
    """
    out = {}
    for var in variables:
        x = np.stack([np.ravel(np.asarray(getattr(p, var)))
                      for p in param_list])
        g = np.stack([np.ravel(np.asarray(getattr(gr, var)))
                      for gr in grad_list])
        out[var] = float(imq_ksd(jnp.asarray(x), jnp.asarray(g), c, beta,
                                 max_block_size))
    return out
