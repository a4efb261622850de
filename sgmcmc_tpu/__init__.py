"""sgmcmc_tpu — stochastic-gradient MCMC for state-space models on accelerators.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the reference
NumPy package `sgmcmc_ssm` (arXiv:1901.10568 course fork, mounted at
/root/reference): buffered-subsequence SG-MCMC (SGLD/SGRLD/SGD/ADAGRAD/
SGLD-CV/Gibbs), Fisher-identity particle-filter score estimation (Nemeth,
Poyiadjis O(N)/O(N^2), PaRIS smoothers), exact Kalman message passing as the
LGSSM oracle, and LGSSM/SVM/GARCH/HMM model families — redesigned as
vmapped/sharded `lax.scan` programs and Pallas kernels for GPUs.
"""

__version__ = "0.1.0"

# Root exports mirror the reference's (`sgmcmc_ssm/__init__.py:1-2`
# exports SGMCMCSampler, SGMCMCHelper, SamplerEvaluator) plus the
# per-model sampler classes.  Resolved lazily so that
# `import sgmcmc_tpu` stays cheap.
_EXPORTS = {
    "Sampler": "sgmcmc_tpu.inference.samplers",
    "SeqSampler": "sgmcmc_tpu.inference.samplers",
    "LGSSMSampler": "sgmcmc_tpu.inference.samplers",
    "SVMSampler": "sgmcmc_tpu.inference.samplers",
    "SVJMSampler": "sgmcmc_tpu.inference.samplers",
    "GARCHSampler": "sgmcmc_tpu.inference.samplers",
    "GaussHMMSampler": "sgmcmc_tpu.inference.samplers",
    "ARPHMMSampler": "sgmcmc_tpu.inference.samplers",
    "SLDSSampler": "sgmcmc_tpu.inference.samplers",
    "SeqSVMSampler": "sgmcmc_tpu.inference.samplers",
    "SeqSVJMSampler": "sgmcmc_tpu.inference.samplers",
    "SeqGARCHSampler": "sgmcmc_tpu.inference.samplers",
    "SeqLGSSMSampler": "sgmcmc_tpu.inference.samplers",
    "SeqGaussHMMSampler": "sgmcmc_tpu.inference.samplers",
    "SeqARPHMMSampler": "sgmcmc_tpu.inference.samplers",
    "sampler_for_model": "sgmcmc_tpu.inference.samplers",
    "ModelAPI": "sgmcmc_tpu.models.registry",
    "get_model": "sgmcmc_tpu.models.registry",
    "BaseEvaluator": "sgmcmc_tpu.evaluation.evaluator",
    "SamplerEvaluator": "sgmcmc_tpu.evaluation.evaluator",
    "OfflineEvaluator": "sgmcmc_tpu.evaluation.evaluator",
}

__all__ = ["__version__", *_EXPORTS]


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'sgmcmc_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
