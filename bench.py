"""Headline benchmark: aggregate SGLD steps/s on the flagship SVM config.

Runs the full buffered-PF SGLD update (subsequence sampling, N=1024-particle
Poyiadjis-O(N) Fisher-identity score over a S=40/B=10 window, prior
gradient, Langevin noise, projection) for 8192 vmapped chains on one
device — through the public multi-chain API
(`Sampler.fit_scan(num_chains=...)`, record='none'), so the number is
exactly what a user of the documented surface gets.  ``resample_mode``
is 'auto': the fused window kernel where the platform has one
(`ops/dispatch.py`), the plain gather path elsewhere.

Prints exactly one JSON line, naming the device it ran on; exits non-zero
without printing a result where JAX finds no GPU.
"""
import json
import time

import jax
import numpy as np

from sgmcmc_tpu.inference.samplers import SVMSampler
from sgmcmc_tpu.models import svm
from sgmcmc_tpu.utils.runtime import (card_identity, enable_compile_cache,
                                      require_gpu)

N_PARTICLES = 1024
N_CHAINS = 8192
SUBSEQ, BUFFER = 40, 10
T = 1000
ITERS = 20


def main():
    enable_compile_cache()
    require_gpu(jax.devices())
    key = jax.random.PRNGKey(0)
    true = svm.from_scalars(A=0.9, Q=0.5, R=1.0)
    ys, _ = svm.generate_data(jax.random.fold_in(key, 1), true, T)

    sampler = SVMSampler(observations=ys, seed=2)
    sampler.parameters = svm.from_scalars(A=0.5, Q=1.0, R=2.0)
    kw = dict(
        N=N_PARTICLES, subsequence_length=SUBSEQ, buffer_length=BUFFER,
        pf="poyiadjis_N", resampler="systematic", resample_mode="auto")

    def run():
        _, aux = sampler.fit_scan(
            "SGLD", num_iters=ITERS, epsilon=0.1, num_chains=N_CHAINS,
            record="none", return_aux=True, **kw)
        return jax.block_until_ready(aux)

    run()                       # warm-up (compile)
    t0 = time.perf_counter()
    aux = run()
    dt = time.perf_counter() - t0
    if not np.all(np.isfinite(np.asarray(aux))):
        raise SystemExit("non-finite log-likelihoods")

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": f"aggregate SGLD steps/s, SVM, {N_PARTICLES} particles, "
                  f"S={SUBSEQ} B={BUFFER}, Poyiadjis O(N), "
                  f"{N_CHAINS} chains, 1 device",
        "value": N_CHAINS * ITERS / dt,
        "unit": "steps/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_identity(),
    }))


if __name__ == "__main__":
    main()
