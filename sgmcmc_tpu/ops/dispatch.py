"""Which particle-filter path runs, decided in one place from the platform.

The buffered PF score has two implementations with the same estimator:

* ``gather`` — plain JAX (`ops/buffered.run_buffered_pf`): a ``lax.scan``
  over the window with ``searchsorted`` + ``take`` resampling.  Runs on
  every platform.
* ``fused`` — the whole-window Pallas kernel (`ops/pallas/fused_pf.py`),
  compiled through Triton for the GPU.

``resample_mode`` picks between them: ``"gather"`` and ``"fused"`` ask
for one; ``"auto"`` takes the kernel where the platform has it and the
configuration qualifies, otherwise the plain path.  Asking for a kernel
the platform lacks raises; nothing falls back to the Pallas interpreter
on a user path (tests opt in with the ``interpret_kernels`` fixture,
which adds the CPU to :data:`KERNEL_PLATFORMS` as interpreted).
"""
from __future__ import annotations

from typing import NamedTuple

import jax

RESAMPLE_MODES = ("auto", "gather", "fused")

# Resample modes of earlier releases whose kernels no longer exist.
_REMOVED_MODES = ("pallas", "pallas2", "xla", "xla2")

# platform (`jax.default_backend()`) -> whether its window kernel runs in
# the Pallas interpreter.  Only compiled kernels are listed here.
KERNEL_PLATFORMS: dict[str, bool] = {"gpu": False}


class PFPath(NamedTuple):
    fused: bool               # run the whole-window kernel
    interpret: bool = False   # ... in the Pallas interpreter


def check_resample_mode(mode: str) -> str:
    if mode in _REMOVED_MODES:
        raise ValueError(
            f"resample_mode='{mode}' was removed with the one-hot "
            f"resample kernels; use one of {RESAMPLE_MODES}")
    if mode not in RESAMPLE_MODES:
        raise ValueError(f"Unrecognized resample_mode '{mode}'; choose from "
                         f"{RESAMPLE_MODES}")
    return mode


def pf_path(resample_mode: str, eligible: bool) -> PFPath:
    """Choose the PF path for ``resample_mode`` on the current platform.

    ``eligible``: the configuration fits the window kernel (a model bundle,
    an O(N) smoother, systematic resampling, a supported particle count).
    """
    check_resample_mode(resample_mode)
    platform = jax.default_backend()
    has_kernel = platform in KERNEL_PLATFORMS
    if resample_mode == "fused":
        if not eligible:
            raise ValueError(
                "resample_mode='fused' needs a model with a fused bundle, "
                "smoother 'poyiadjis_N' or 'nemeth', resampler "
                "'systematic' and a power-of-two particle count >= 16")
        if not has_kernel:
            raise ValueError(
                f"no compiled window kernel for platform '{platform}' "
                f"(available: {sorted(KERNEL_PLATFORMS)}); use "
                f"resample_mode='gather' or 'auto'")
    elif resample_mode == "gather" or not (eligible and has_kernel):
        return PFPath(fused=False)
    return PFPath(fused=True, interpret=KERNEL_PLATFORMS[platform])
