"""Texture-sampling parity: jax samplers vs the scalar oracle samplers and
GPU sampler semantics (texel centers, clamp-to-edge)."""

import numpy as np
import pytest

from vpt_tpu.ops import interp
from vpt_tpu.reference import oracle


def test_volume_sample_matches_oracle():
    rng = np.random.default_rng(1)
    vol = rng.uniform(size=(8, 9, 10)).astype(np.float32)
    pts = rng.uniform(-0.2, 1.2, size=(100, 3)).astype(np.float32)
    got = np.asarray(
        interp.sample_volume(vol, pts[:, 0], pts[:, 1], pts[:, 2], "linear")
    )
    want = np.array([oracle.sample_volume(vol, *p) for p in pts])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_volume_sample_at_texel_centers():
    vol = np.arange(8, dtype=np.float32).reshape(2, 2, 2)
    # texel center of voxel (0,0,0) in a 2^3 texture is u=v=w=0.25
    v = float(interp.sample_volume(vol, np.float32(0.25), np.float32(0.25), np.float32(0.25)))
    assert v == pytest.approx(0.0)
    v = float(interp.sample_volume(vol, np.float32(0.75), np.float32(0.75), np.float32(0.75)))
    assert v == pytest.approx(7.0)
    # midpoint: mean of all 8
    v = float(interp.sample_volume(vol, np.float32(0.5), np.float32(0.5), np.float32(0.5)))
    assert v == pytest.approx(3.5)


def test_volume_sample_clamps():
    vol = np.arange(8, dtype=np.float32).reshape(2, 2, 2)
    inside = float(interp.sample_volume(vol, np.float32(0.25), np.float32(0.25), np.float32(0.25)))
    outside = float(interp.sample_volume(vol, np.float32(-5.0), np.float32(-5.0), np.float32(-5.0)))
    assert outside == pytest.approx(inside)


def test_nearest_mode():
    vol = np.arange(8, dtype=np.float32).reshape(2, 2, 2)
    v = float(interp.sample_volume(vol, np.float32(0.4), np.float32(0.4), np.float32(0.4), "nearest"))
    assert v == 0.0
    v = float(interp.sample_volume(vol, np.float32(0.6), np.float32(0.6), np.float32(0.6), "nearest"))
    assert v == 7.0


def test_quasicubic_interpolates_endpoints():
    vol = np.arange(8, dtype=np.float32).reshape(2, 2, 2)
    a = float(interp.sample_volume(vol, np.float32(0.25), np.float32(0.25), np.float32(0.25), "quasicubic"))
    assert a == pytest.approx(0.0, abs=1e-6)
    mid = float(interp.sample_volume(vol, np.float32(0.5), np.float32(0.5), np.float32(0.5), "quasicubic"))
    assert mid == pytest.approx(3.5, abs=1e-5)  # smoothstep(0.5) = 0.5


def test_tex2d_matches_oracle():
    rng = np.random.default_rng(2)
    tex = rng.uniform(size=(16, 17, 4)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, size=(50, 2)).astype(np.float32)
    got = np.asarray(interp.sample_tex2d(tex, uv[:, 0], uv[:, 1]))
    want = np.array([oracle.sample_tex2d(tex, u, v) for u, v in uv])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_packed_tex1d_gather_matches_oracle():
    """The packed (N+1, 2) pair table is sampled by one row gather per
    sample; it must match the oracle's two-tap lerp of the raw texture,
    including clamp-to-edge outside [0, 1]."""
    rng = np.random.default_rng(4)
    tex = rng.uniform(size=(256,)).astype(np.float32)
    us = rng.uniform(-0.1, 1.1, size=(5, 40)).astype(np.float32)
    got = np.asarray(interp.sample_tex1d(interp.pack_tex1d_corners(tex), us))
    want = np.array([[oracle.sample_tex1d(tex, u) for u in row] for row in us])
    assert got.shape == us.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_tex1d_matches_oracle():
    rng = np.random.default_rng(3)
    tex = rng.uniform(size=(256,)).astype(np.float32)
    us = rng.uniform(-0.1, 1.1, size=50).astype(np.float32)
    got = np.asarray(interp.sample_tex1d(tex, us))
    want = np.array([oracle.sample_tex1d(tex, u) for u in us])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
