"""Packed corner tables must be bit-identical to the 8-gather/4-gather path."""

import numpy as np

import jax.numpy as jnp

from vpt_tpu.ops import interp


def test_packed_volume_bit_exact():
    rng = np.random.default_rng(0)
    vol = rng.uniform(size=(7, 9, 11)).astype(np.float32)
    packed = interp.pack_volume_corners(vol)
    assert packed.shape == (8, 10, 12, 8)
    pts = rng.uniform(-0.3, 1.3, size=(500, 3)).astype(np.float32)
    for mode in ("linear", "quasicubic"):
        a = np.asarray(interp.sample_volume(jnp.asarray(vol), pts[:, 0], pts[:, 1], pts[:, 2], mode))
        b = np.asarray(interp.sample_volume(jnp.asarray(packed), pts[:, 0], pts[:, 1], pts[:, 2], mode))
        np.testing.assert_array_equal(a, b)


def test_packed_tex2d_bit_exact():
    rng = np.random.default_rng(1)
    tex = rng.uniform(size=(16, 17, 4)).astype(np.float32)
    packed = interp.pack_tex2d_corners(tex)
    assert packed.shape == (17, 18, 16)
    uv = rng.uniform(-0.2, 1.2, size=(300, 2)).astype(np.float32)
    a = np.asarray(interp.sample_tex2d(jnp.asarray(tex), uv[:, 0], uv[:, 1]))
    b = np.asarray(interp.sample_tex2d(jnp.asarray(packed), uv[:, 0], uv[:, 1]))
    np.testing.assert_array_equal(a, b)


def test_packed_renderer_matches_unpacked():
    from vpt_tpu.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import (LightConfig, MaterialTF,
                                      MCMSpectralConfig, SpectrumConfig)

    vol = Volume.sphere_in_cube(16)
    args = (MaterialTF.constant(0.8, 0.6, 0.3), LightConfig(),
            SpectrumConfig(), MCMSpectralConfig(extinction=20.0, steps=6))
    cam = Camera()
    rp = MCMSpectralRenderer(vol, *args, resolution=16, pack_tables=True)
    ru = MCMSpectralRenderer(vol, *args, resolution=16, pack_tables=False)
    sp = rp.reset(cam, 3)
    su = ru.reset(cam, 3)
    for f in range(3):
        sp, ip = rp.render(sp, cam, f + 1)
        su, iu = ru.render(su, cam, f + 1)
    np.testing.assert_array_equal(np.asarray(ip), np.asarray(iu))
    np.testing.assert_array_equal(np.asarray(sp.samples), np.asarray(su.samples))


def test_packed_tex1d_bit_exact():
    rng = np.random.default_rng(2)
    tex = rng.uniform(size=(256,)).astype(np.float32)
    packed = interp.pack_tex1d_corners(tex)
    assert packed.shape == (257, 2)
    us = rng.uniform(-0.2, 1.2, size=300).astype(np.float32)
    a = np.asarray(interp.sample_tex1d(jnp.asarray(tex), us))
    b = np.asarray(interp.sample_tex1d(jnp.asarray(packed), us))
    np.testing.assert_array_equal(a, b)


def test_streams_converge_to_same_image():
    """S>1 sample streams must estimate the same image as S=1 (different
    sample sequences, same distribution) and stream 0 must be bit-identical
    to the S=1 layout after reset."""
    from vpt_tpu.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import (LightConfig, MaterialTF,
                                      MCMSpectralConfig, SpectrumConfig)

    vol = Volume.sphere_in_cube(16)
    args = (MaterialTF.constant(0.8, 0.6), LightConfig(),
            SpectrumConfig(), MCMSpectralConfig(extinction=20.0, steps=4))
    cam = Camera()
    r1 = MCMSpectralRenderer(vol, *args, resolution=16, streams=1)
    r4 = MCMSpectralRenderer(vol, *args, resolution=16, streams=4)

    s1 = r1.reset(cam, 3)
    s4 = r4.reset(cam, 3)
    assert np.asarray(s4.px).shape == (4, 16, 16)
    np.testing.assert_array_equal(np.asarray(s4.px)[0], np.asarray(s1.px))
    np.testing.assert_array_equal(np.asarray(s4.wavelength)[0],
                                  np.asarray(s1.wavelength))

    for f in range(24):
        s1, i1 = r1.render(s1, cam, f + 1)
        s4, i4 = r4.render(s4, cam, f + 1)
    i1, i4 = np.asarray(i1), np.asarray(i4)
    assert i4.shape == i1.shape == (16, 16, 3)
    # 4x the samples -> same expected image within MC noise
    assert np.abs(i1.mean() - i4.mean()) < 0.15
    assert np.corrcoef(i1.ravel(), i4.ravel())[0, 1] > 0.8


def test_fused_tex2d_tex1d_bit_exact():
    """The fused TF+light table must reproduce both lookups bit-exactly."""
    rng = np.random.default_rng(3)
    tex2 = rng.uniform(size=(16, 32, 4)).astype(np.float32)
    tex1 = rng.uniform(size=(32,)).astype(np.float32)
    fused = interp.pack_tex2d_with_tex1d(tex2, tex1)
    assert fused.shape == (17, 33, 18)
    uv = rng.uniform(-0.2, 1.2, size=(300, 2)).astype(np.float32)
    mat, aux = interp.sample_tex2d_fused1d(
        jnp.asarray(fused), uv[:, 0], uv[:, 1])
    a2 = np.asarray(interp.sample_tex2d(jnp.asarray(tex2), uv[:, 0], uv[:, 1]))
    a1 = np.asarray(interp.sample_tex1d(jnp.asarray(tex1), uv[:, 0]))
    np.testing.assert_array_equal(np.asarray(mat), a2)
    np.testing.assert_array_equal(np.asarray(aux), a1)


def test_packed_volume_xy_bit_exact():
    """4x half packing (2 gathers/step big-volume mode) == raw 8-gather."""
    rng = np.random.default_rng(5)
    vol = rng.uniform(size=(7, 9, 11)).astype(np.float32)
    packed = interp.pack_volume_corners_xy(vol)
    assert packed.shape == (7, 10, 12, 4)
    pts = rng.uniform(-0.3, 1.3, size=(500, 3)).astype(np.float32)
    for mode in ("linear", "quasicubic"):
        a = np.asarray(interp.sample_volume(
            jnp.asarray(vol), pts[:, 0], pts[:, 1], pts[:, 2], mode))
        b = np.asarray(interp.sample_volume(
            jnp.asarray(packed), pts[:, 0], pts[:, 1], pts[:, 2], mode))
        np.testing.assert_array_equal(a, b)


def test_xy_packed_renderer_matches_unpacked():
    from vpt_tpu.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import (LightConfig, MaterialTF,
                                      MCMSpectralConfig, SpectrumConfig)

    vol = Volume.sphere_in_cube(16)
    args = (MaterialTF.constant(0.8, 0.6, 0.3), LightConfig(),
            SpectrumConfig(), MCMSpectralConfig(extinction=20.0, steps=6))
    cam = Camera()
    rp = MCMSpectralRenderer(vol, *args, resolution=16,
                             pack_tables={"density_xy", "material_tf",
                                          "light_spectrum"})
    ru = MCMSpectralRenderer(vol, *args, resolution=16, pack_tables=False)
    sp, su = rp.reset(cam, 3), ru.reset(cam, 3)
    for f in range(3):
        sp, ip = rp.render(sp, cam, f + 1)
        su, iu = ru.render(su, cam, f + 1)
    np.testing.assert_array_equal(np.asarray(ip), np.asarray(iu))


def test_flat_packed_volume_bit_exact():
    """PackedVolume (flat 2-D storage, the big-table layout) samples
    bit-identically to the raw grid and the legacy 4-D packed table, for
    both full and xy packings and both filter modes."""
    import jax.numpy as jnp
    import numpy as np

    from vpt_tpu.ops import interp
    from vpt_tpu.scene.volume import Volume

    vol = Volume.sphere_in_cube(16).density
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.random(500, dtype=np.float32) * 1.2 - 0.1)
    v = jnp.asarray(rng.random(500, dtype=np.float32) * 1.2 - 0.1)
    w = jnp.asarray(rng.random(500, dtype=np.float32) * 1.2 - 0.1)

    for kind, pack4d in (("full", interp.pack_volume_corners),
                         ("xy", interp.pack_volume_corners_xy)):
        flat = interp.PackedVolume.pack(vol, kind)
        packed4d = jnp.asarray(pack4d(vol))
        for mode in ("linear", "quasicubic"):
            want = np.asarray(interp.sample_volume(jnp.asarray(vol), u, v, w, mode))
            got4 = np.asarray(interp.sample_volume(packed4d, u, v, w, mode))
            gotf = np.asarray(interp.sample_volume(flat, u, v, w, mode))
            np.testing.assert_array_equal(got4, want, err_msg=f"{kind}/{mode} 4D")
            np.testing.assert_array_equal(gotf, want, err_msg=f"{kind}/{mode} flat")


def test_pack_volume_auto_picks_by_size():
    """pack_volume_auto always returns a flat PackedVolume, at every size;
    only the stored dtype follows the source (u8 for u8-quantized
    volumes, f32 otherwise, or what the caller forces)."""
    import numpy as np

    from vpt_tpu.ops import interp
    from vpt_tpu.scene.volume import Volume

    vol = Volume.sphere_in_cube(16).density
    q8 = interp.pack_volume_auto(vol, "full")
    assert isinstance(q8, interp.PackedVolume) and q8.table.dtype == np.uint8
    assert q8.dims == (17, 17, 17) and q8.kind == "full"
    volf = np.asarray(vol) * 0.7134
    for kind, dims in (("full", (17, 17, 17)), ("xy", (16, 17, 17))):
        f = interp.pack_volume_auto(volf, kind)
        assert isinstance(f, interp.PackedVolume)
        assert f.table.dtype == np.float32
        assert f.dims == dims and f.kind == kind
        assert f.table.shape == (f.n_rows, f.width)
    forced = interp.pack_volume_auto(vol, "full", table_dtype="f32")
    assert forced.table.dtype == np.float32


def test_quantized_packed_volume_dtypes():
    """u8 packed tables reproduce the f32 values BIT-EXACTLY for all 256
    codes (round-5 correction of the r4 record): plain /255 lowers to a
    reciprocal multiply 1 ulp off for 126/256 codes; the r4 "compensated
    two-term" constant was itself wrong for 121/256 codes in pure f32
    arithmetic (k*c_hi already rounds) and its on-chip "max-diff 0.0" was
    scene luck (sphere_in_cube only contains codes {0, 100, 255}). The
    shipped form is a barriered Newton residual step (interp._INV255
    comment) — exact for EVERY code, asserted here over a volume
    containing all 256 codes. bench.py and chip_smoke.py re-assert the
    same property on the GPU (the barrier keeps XLA's simplifier from
    folding the step back to the reciprocal form). bf16 is lossy within
    ~2^-8; non-quantized sources are rejected for u8."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from vpt_tpu.ops import interp

    # isolated dequantize: exact for all 256 codes
    codes = np.arange(256, dtype=np.uint8)
    got = np.asarray(jax.jit(interp._dequantize_rows)(
        jnp.asarray(codes[:, None])))
    want_codes = codes.astype(np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(got[:, 0], want_codes)

    # kernel-level: a volume containing ALL 256 codes, sampled through the
    # real trilinear path — u8 must be bit-identical to f32
    vol = (codes.reshape(4, 8, 8).astype(np.float32)
           / np.float32(255.0))
    rng = np.random.default_rng(4)
    u = jnp.asarray(rng.random(500, dtype=np.float32) * 1.2 - 0.1)
    v = jnp.asarray(rng.random(500, dtype=np.float32) * 1.2 - 0.1)
    w = jnp.asarray(rng.random(500, dtype=np.float32) * 1.2 - 0.1)

    for kind in ("full", "xy"):
        want = np.asarray(interp.sample_volume(
            interp.PackedVolume.pack(vol, kind), u, v, w, "linear"))
        got_u8 = np.asarray(interp.sample_volume(
            interp.PackedVolume.pack(vol, kind, table_dtype="u8"),
            u, v, w, "linear"))
        got_bf16 = np.asarray(interp.sample_volume(
            interp.PackedVolume.pack(vol, kind, table_dtype="bf16"),
            u, v, w, "linear"))
        np.testing.assert_array_equal(got_u8, want,
                                      err_msg=f"{kind} u8 (bit-exact)")
        np.testing.assert_allclose(got_bf16, want, atol=1 / 256.0,
                                   err_msg=f"{kind} bf16")

    with pytest.raises(AssertionError):
        interp.PackedVolume.pack(
            np.full((4, 4, 4), 0.3004, np.float32), table_dtype="u8")
