"""Execute the multi-device scaling harness (parallel/scaling.py) in CI.

These tests run `scaling_sweep` and `collective_microbench` on the virtual
8-device CPU mesh on every CI run — the same harness the real multi-card
sweep uses (BASELINE config 5 scaling row). Thresholds are deliberately
loose: a CPU host emulating 8 devices shares its cores, so parallel
efficiency is NOT expected to approach the >=85% target of a real
interconnect here — the assertions pin that
the harness runs end-to-end, returns finite numbers, and that adding
devices does not corrupt results (weak-scaling work actually happens).
"""

import jax
import numpy as np
import pytest

from vpt_tpu.parallel.mesh import ray_mesh
from vpt_tpu.parallel.scaling import (
    collective_microbench,
    initialize_distributed,
    scaling_sweep,
)


def test_initialize_distributed_is_safe_single_process(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert initialize_distributed() is False


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_collective_microbench_reports_finite_bandwidth():
    out = collective_microbench(ray_mesh(8), size_mb=4.0, reps=3)
    assert out["devices"] == 8
    for key in ("psum_s", "psum_GBps", "all_gather_s", "all_gather_GBps"):
        assert np.isfinite(out[key]), (key, out)
        assert out[key] > 0, (key, out)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_scaling_sweep_runs_and_scales():
    rows = scaling_sweep(
        device_counts=[1, 2, 8],
        rows_per_device=16,
        width=32,
        volume_size=16,
        steps=4,
        dispatches=4,
        verbose=False,
    )
    assert [r["devices"] for r in rows] == [1, 2, 8]
    for r in rows:
        assert np.isfinite(r["rays_per_s"]) and r["rays_per_s"] > 0
        assert r["rows"] == 16 * r["devices"]
        # the weak-scaling contract: per-device lane count
        # is CONSTANT across the sweep
        assert r["lanes_per_device"] == 16 * 32
    # single-device efficiency is 1 by definition; multi-device runs must
    # complete with sane (finite, positive) efficiency — the tight >=85%
    # bound is a real-interconnect target, not a shared-CPU-host one
    assert rows[0]["efficiency"] == 1.0
    assert all(np.isfinite(r["efficiency"]) and r["efficiency"] > 0 for r in rows)
