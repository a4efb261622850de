"""Profiling helpers: wall-clock split timer and profiler trace."""
import jax.numpy as jnp

from sgmcmc_tpu.utils import profiling


def test_timer_sections_accumulate():
    t = profiling.Timer()
    with t.section("a"):
        pass
    with t.section("a"):
        pass
    with t.section("b"):
        pass
    assert t.counts == {"a": 2, "b": 1}
    rows = t.rows()
    assert {r["variable"] for r in rows} == {"a", "b"}
    assert all(r["metric"] == "runtime" for r in rows)


def test_timer_section_records_on_exception():
    """A section that raises still books its time (the split timer wraps
    sampler steps that may fail, `evaluator.py:325-365`)."""
    t = profiling.Timer()
    try:
        with t.section("fail"):
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    assert t.counts == {"fail": 1} and t.totals["fail"] >= 0.0


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        float(jnp.sum(jnp.arange(64.0) ** 2))
    import os
    found = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
    assert found, "profiler wrote no trace files"
