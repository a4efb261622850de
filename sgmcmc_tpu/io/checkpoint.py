"""Checkpoint / resume and atomic file IO.

Rewrite of the reference's filesystem persistence
(`/root/reference/sgmcmc_ssm/driver_utils.py:114-226` and the fit-state
checkpointing protocol in the drivers, e.g. `svm/driver.py:387-408,509-528`):
atomic write via tempfile+rename, race-tolerant mkdir, and pickling of
parameter pytrees (converted to NumPy so checkpoints are
device/backend-independent).
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time

import jax
import numpy as np


def make_path(path: str) -> str:
    """Race-tolerant mkdir -p (`driver_utils.py:114-142`)."""
    for _ in range(5):
        try:
            os.makedirs(path, exist_ok=True)
            return path
        except OSError:
            time.sleep(np.random.rand())
    os.makedirs(path, exist_ok=True)
    return path


def atomic_write(path: str, write_fn) -> None:
    """Write via tempfile + atomic rename (`atomic_overwrite`,
    `driver_utils.py:184-196`)."""
    d = os.path.dirname(os.path.abspath(path))
    make_path(d)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def tree_to_numpy(tree):
    """Device pytree -> NumPy pytree (host, backend-independent)."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def save_pickle(path: str, obj) -> None:
    atomic_write(path, lambda f: pickle.dump(obj, f, protocol=4))


def load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_checkpoint(path: str, *, parameters, key=None, iteration=0,
                    extra=None) -> None:
    """Fit-state checkpoint: parameters pytree + PRNG key + counters."""
    state = dict(
        parameters=tree_to_numpy(parameters),
        key=None if key is None else np.asarray(key),
        iteration=int(iteration),
        extra=extra,
    )
    save_pickle(path, state)


def load_checkpoint(path: str):
    return load_pickle(path)


def save_dataframe(path: str, df) -> None:
    """Atomic CSV write (`pandas_write_df_to_csv`,
    `driver_utils.py:198-221`)."""
    atomic_write(path, lambda f: f.write(df.to_csv(index=False).encode()))


def stack_trace(parameters_list):
    """Stack a list of parameter pytrees into one pytree with a leading
    trace axis and fetch it to host in a single transfer (one transfer per
    element would pay a device sync each)."""
    import jax.numpy as jnp
    stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
        *parameters_list)
    return jax.device_get(stacked)


def unstack_trace(stacked):
    """Inverse of :func:`stack_trace`: pytree-with-trace-axis -> list."""
    leaves, treedef = jax.tree_util.tree_flatten(stacked)
    n = leaves[0].shape[0]
    return [jax.tree_util.tree_unflatten(
        treedef, [leaf[i] for leaf in leaves]) for i in range(n)]


def save_trace(path: str, parameters_list, times=None, extra=None) -> None:
    """Persist a parameter trace (list of pytrees) + optional wall times.

    ``extra``: additional top-level entries (e.g. the multi-chain driver's
    stacked ``chain_parameters`` pytree)."""
    stacked = stack_trace(parameters_list)
    out = dict(
        parameters_list=unstack_trace(stacked),
        times=None if times is None else list(times),
    )
    if extra:
        out.update(extra)
    save_pickle(path, out)


def load_trace(path: str):
    return load_pickle(path)
