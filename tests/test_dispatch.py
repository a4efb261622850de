"""Path selection (`ops/dispatch.py`): platform -> PF path, raising on a
kernel the platform lacks, never interpreting on a user path."""
import jax
import pytest

from sgmcmc_tpu.inference import sgmcmc
from sgmcmc_tpu.ops import dispatch
from sgmcmc_tpu.ops.dispatch import PFPath, pf_path


@pytest.fixture
def platform(monkeypatch):
    def set_platform(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
    return set_platform


@pytest.mark.parametrize("name, eligible, path", [
    ("gpu", True, PFPath(True, False)),
    ("gpu", False, PFPath(False)),
    ("cpu", True, PFPath(False)),
    ("cpu", False, PFPath(False)),
    ("metal", True, PFPath(False)),
])
def test_auto_picks_kernel_only_where_compiled(platform, name, eligible,
                                               path):
    platform(name)
    assert pf_path("auto", eligible) == path


@pytest.mark.parametrize("name", ["gpu", "cpu", "metal"])
def test_gather_is_plain_everywhere(platform, name):
    platform(name)
    assert pf_path("gather", True) == PFPath(False)


@pytest.mark.parametrize("name", ["cpu", "metal", "rocm"])
def test_fused_raises_without_kernel(platform, name):
    platform(name)
    with pytest.raises(ValueError, match="no compiled window kernel"):
        pf_path("fused", True)


def test_fused_raises_when_ineligible(platform):
    platform("gpu")
    with pytest.raises(ValueError, match="power-of-two"):
        pf_path("fused", False)


def test_no_user_path_interprets():
    assert not any(dispatch.KERNEL_PLATFORMS.values())


def test_interpret_fixture_adds_cpu(interpret_kernels):
    assert pf_path("auto", True) == PFPath(True, True)


@pytest.mark.parametrize("mode", ["pallas", "pallas2", "xla", "xla2"])
def test_removed_modes_raise(mode):
    with pytest.raises(ValueError, match="removed"):
        pf_path(mode, True)
    with pytest.raises(ValueError, match="removed"):
        sgmcmc.PFScoreConfig(resample_mode=mode)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="Unrecognized"):
        dispatch.check_resample_mode("onehot")


@pytest.mark.parametrize("kw, ok", [
    (dict(), True),
    (dict(smoother="nemeth"), True),
    (dict(smoother="paris"), False),
    (dict(resampler="multinomial"), False),
    (dict(n_particles=1000), False),
])
def test_fused_eligibility(kw, ok):
    from sgmcmc_tpu.models import svm
    cfg = sgmcmc.PFScoreConfig(**{**dict(n_particles=1024,
                                         smoother="poyiadjis_N",
                                         resampler="systematic"), **kw})
    assert sgmcmc._fused_eligible(cfg, svm.FUSED) is ok
    assert sgmcmc._fused_eligible(cfg, None) is False
