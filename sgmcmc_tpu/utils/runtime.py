"""Process set-up shared by the entry points (`chip_smoke.py`, `bench.py`,
the experiment driver): the persistent compile cache, the GPU check and
the card's identity.
"""
from __future__ import annotations

import os
import pathlib
import subprocess

import jax

# A fixed path: the cache key includes it, so a directory that moves
# between runs never hits.
CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is set here.  Otherwise the cache lives in ``<repo>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def require_gpu(devices) -> None:
    """Refuse to measure anywhere but on a GPU (no CPU fallback)."""
    platform = devices[0].platform if devices else None
    if platform != "gpu":
        raise SystemExit(f"no GPU found (JAX platform {platform!r}); "
                         f"nothing was measured")


def card_identity() -> str:
    """The cards' name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
