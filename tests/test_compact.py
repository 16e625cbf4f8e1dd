"""Hit-lane compaction: conservative classification, hit-pixel parity with
the full kernel, closed-form miss pixels, determinism."""

import numpy as np
import pytest

import jax.numpy as jnp

from vpt_tpu.models import mcm_spectral as M
from vpt_tpu.models import mcm_spectral_compact as C
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import (
    LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig,
)

RES = 24


def _renderers(streams=2, steps=6, compaction=True):
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    kw = dict(
        volume=Volume.sphere_in_cube(16),
        material_tf=MaterialTF(table),
        light=LightConfig(direction=(1.0, 0.2, 0.5)),
        spectrum=SpectrumConfig(),
        config=MCMSpectralConfig(extinction=30.0, bounces=8, steps=steps),
        resolution=RES, streams=streams,
    )
    full = M.MCMSpectralRenderer(**kw)
    comp = M.MCMSpectralRenderer(**kw, compaction=True) if compaction else None
    return full, comp


def test_mask_is_conservative():
    """Every pixel classified miss must have its ENTIRE jitter bundle miss
    the cube — checked against the kernel's own unproject math at the
    jitter extremes + interior samples, for the default pose and a
    frustum-filling pose (which must classify everything hit)."""
    for cam, expect_misses in ((Camera(), True),
                               (Camera(translation=np.array([0, 0, 1.2])),
                                False)):
        inv_mvp = cam.inverse_mvp()
        hit = C.hit_pixel_mask(inv_mvp, RES)
        if not expect_misses:
            assert hit.all()
            continue
        assert (~hit).any() and hit.any()
        inv_res = 1.0 / RES
        iy, ix = np.nonzero(~hit)
        sx = ((ix + 0.5) / RES - 0.5) * 2.0
        sy = ((iy + 0.5) / RES - 0.5) * -2.0
        apex = C._unproject_np(inv_mvp, sx, sy, -1.0)
        for ja in np.linspace(-1, 1, 5):
            for jb in np.linspace(-1, 1, 5):
                far = C._unproject_np(inv_mvp, sx + ja * inv_res,
                                      sy + jb * inv_res, 1.0)
                d = far - apex
                tn, tf = C_intersect(apex, d)
                assert (np.maximum(tn, 0.0) >= np.maximum(tf, 0.0)).all()


def C_intersect(o, d):
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (0.0 - o) / d
        t1 = (1.0 - o) / d
    tn = np.minimum(t0, t1).max(axis=-1)
    tf = np.maximum(t0, t1).min(axis=-1)
    return tn, tf


def test_hit_pixels_match_full_kernel():
    """Compacted lanes reproduce the full kernel's hit-pixel estimates for
    the same seeds (same per-lane chains; only the stream-average float
    order differs)."""
    full, comp = _renderers()
    cam = Camera()
    seeds = [(k + 1) * 2654435761 % 2**32 for k in range(10)]

    sf = full.reset(cam, seeds[0])
    sf, img_full = full.render_many(sf, cam, seeds)
    sc = comp.reset(cam, seeds[0])
    sc, img_comp = comp.render_many(sc, cam, seeds)

    hit = np.asarray(comp._compact_tables(cam)["hit"])
    a = np.asarray(img_full)[hit]
    b = np.asarray(img_comp)[hit]
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_miss_pixels_match_converged_estimator():
    """Closed-form miss values agree with the full kernel's converged
    Monte-Carlo estimate within its own seed-to-seed noise floor."""
    full, comp = _renderers(streams=2, steps=6)
    cam = Camera()

    def converged(seed0):
        s = full.reset(cam, seed0)
        seeds = [(seed0 + k + 1) * 2654435761 % 2**32 for k in range(150)]
        s, img = full.render_many(s, cam, seeds)
        return np.asarray(img)

    a, b = converged(1), converged(991)
    sc = comp.reset(cam, 1)
    sc, img_comp = comp.render_many(sc, cam, [1])  # miss part is analytic
    miss = ~np.asarray(comp._compact_tables(cam)["hit"])
    assert miss.any()
    floor = np.abs(a[miss] - b[miss]).mean()
    diff = np.abs(np.asarray(img_comp)[miss] - a[miss]).mean()
    assert diff < 2.0 * floor + 1e-4, (diff, floor)


def test_compact_deterministic_and_padded_lanes_harmless():
    full, comp = _renderers()
    cam = Camera()
    seeds = [(k + 7) * 2654435761 % 2**32 for k in range(4)]
    s1 = comp.reset(cam, 7)
    s1, i1 = comp.render_many(s1, cam, seeds)
    s2 = comp.reset(cam, 7)
    s2, i2 = comp.render_many(s2, cam, seeds)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    assert np.isfinite(np.asarray(i1)).all()
    # the dump row (padding lanes) must not leak into any pixel
    t = comp._compact_tables(cam)
    n_lanes_used = int(t["n_hit"]) * comp.streams
    assert int(np.asarray(t["lane_pixel"]).size) >= n_lanes_used


def test_compact_composes_with_majorant_and_quasicubic():
    """Compaction is orthogonal to the sampling-mode levers: the majorant
    mode and quasicubic filtering both run on compact lanes (lane math is
    shape-generic); converged hit-pixel images agree with the full kernel
    at the seed-to-seed noise floor (majorants change sample paths, so
    bit-parity does not apply)."""
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    vol = Volume.sphere_in_cube(16)
    vol = Volume(vol.density, filter="quasicubic")
    kw = dict(
        volume=vol, material_tf=MaterialTF(table),
        light=LightConfig(direction=(1.0, 0.2, 0.5)),
        spectrum=SpectrumConfig(),
        config=MCMSpectralConfig(extinction=30.0, bounces=8, steps=6),
        resolution=RES, streams=2, majorant_blocks=4,
    )
    full = M.MCMSpectralRenderer(**kw)
    comp = M.MCMSpectralRenderer(**kw, compaction=True)
    cam = Camera()

    def run(r, seed0, n=120):
        s = r.reset(cam, seed0)
        s, img = r.render_many(
            s, cam, [(seed0 + k + 1) * 2654435761 % 2**32 for k in range(n)])
        return np.asarray(img)

    a, b = run(full, 1), run(full, 991)
    c = run(comp, 1)
    hit = np.asarray(comp._compact_tables(cam)["hit"])
    floor = np.abs(a[hit] - b[hit]).mean()
    diff = np.abs(c[hit] - a[hit]).mean()
    assert np.isfinite(c).all()
    assert diff < 2.0 * floor + 1e-4, (diff, floor)


def test_compact_session_checkpoint_resume(tmp_path):
    """The recovery contract holds for compact sessions: kill mid-render,
    reload, continue — bit-identical to an uninterrupted run."""
    from vpt_tpu.session import RenderSession
    from vpt_tpu.scene.volume import Volume as V

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    kw = dict(
        tonemapper="artistic", resolution=RES, base_seed=3,
        streams=2, compaction=True,
    )
    args = (V.sphere_in_cube(16), MaterialTF(table),
            LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
            MCMSpectralConfig(extinction=30.0, bounces=8, steps=4))

    a = RenderSession("mcm-spectral", *args, **kw)
    a.run(6)
    img_ref = np.asarray(a.hdr_image())

    b = RenderSession("mcm-spectral", *args, **kw)
    b.run(3)
    ck = str(tmp_path / "compact.npz")
    b.save_checkpoint(ck)
    c = RenderSession("mcm-spectral", *args, **kw)
    c.load_checkpoint(ck)
    c.run(3)
    np.testing.assert_array_equal(np.asarray(c.hdr_image()), img_ref)


def test_compact_isotropic_light():
    """Isotropic light (|dir| < eps): miss pixels take intensity only."""
    table = np.zeros((256, 256, 4), np.float32)
    table[..., 3] = 0.0
    kw = dict(
        volume=Volume.sphere_in_cube(16),
        material_tf=MaterialTF(table),
        light=LightConfig(direction=(0.0, 0.0, 0.0)),
        spectrum=SpectrumConfig(),
        config=MCMSpectralConfig(extinction=30.0, bounces=8, steps=6),
        resolution=RES, streams=1,
    )
    full = M.MCMSpectralRenderer(**kw)
    comp = M.MCMSpectralRenderer(**kw, compaction=True)
    cam = Camera()

    def converged(seed0):
        s = full.reset(cam, seed0)
        s, img = full.render_many(
            s, cam, [(seed0 + k + 1) * 2654435761 % 2**32
                     for k in range(150)])
        return np.asarray(img)

    a, b = converged(1), converged(991)
    sc = comp.reset(cam, 1)
    sc, img_comp = comp.render_many(sc, cam, [1])
    miss = ~np.asarray(comp._compact_tables(cam)["hit"])
    floor = np.abs(a[miss] - b[miss]).mean()
    diff = np.abs(np.asarray(img_comp)[miss] - a[miss]).mean()
    # the analytic value is the estimator's exact mean; MC at 900 spp still
    # carries one-hot-bin noise, so judge against the seed-to-seed floor
    assert diff < 1.5 * floor + 1e-4, (diff, floor)


def _envmap(seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 1.0, size=(8, 16, 3)).astype(np.float32)


def test_compact_envmap_spectral():
    """Environment-map compaction: hit pixels match the
    full kernel for the same seeds; miss pixels take the env closed form
    (band-fraction x subpixel-averaged equirect quadrature), checked
    against the converged full kernel at its seed-to-seed noise floor."""
    env = _envmap()
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    kw = dict(
        volume=Volume.sphere_in_cube(16),
        material_tf=MaterialTF(table),
        light=LightConfig(direction=(1.0, 0.2, 0.5)),
        spectrum=SpectrumConfig(),
        config=MCMSpectralConfig(extinction=30.0, bounces=8, steps=6),
        resolution=RES, streams=2, environment=env,
    )
    full = M.MCMSpectralRenderer(**kw)
    comp = M.MCMSpectralRenderer(**kw, compaction=True)
    cam = Camera()

    # hit-pixel parity for the same seeds (bit-level chains; only the
    # stream-average float order differs)
    seeds = [(k + 1) * 2654435761 % 2**32 for k in range(10)]
    sf = full.reset(cam, seeds[0])
    sf, img_full = full.render_many(sf, cam, seeds)
    sc = comp.reset(cam, seeds[0])
    sc, img_comp = comp.render_many(sc, cam, seeds)
    hit = np.asarray(comp._compact_tables(cam)["hit"])
    np.testing.assert_allclose(np.asarray(img_comp)[hit],
                               np.asarray(img_full)[hit],
                               rtol=1e-5, atol=1e-6)

    # miss closed form vs converged MC
    def converged(seed0):
        s = full.reset(cam, seed0)
        s, img = full.render_many(
            s, cam, [(seed0 + k + 1) * 2654435761 % 2**32
                     for k in range(150)])
        return np.asarray(img)

    a, b = converged(1), converged(991)
    miss = ~hit
    assert miss.any()
    floor = np.abs(a[miss] - b[miss]).mean()
    diff = np.abs(np.asarray(img_comp)[miss] - a[miss]).mean()
    assert diff < 2.0 * floor + 1e-4, (diff, floor)


def test_band_bin_fractions_sum_and_measure():
    """Per-bin band fractions sum to each bin's probability and to 1 total."""
    bounds = np.linspace(400.0, 700.0, 13)
    frac = C.band_bin_fractions(bounds, 12)
    np.testing.assert_allclose(frac.sum(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(frac.sum(axis=1), np.diff(bounds) / 300.0,
                               rtol=1e-12)
    # band assignment: a bin entirely below 500 nm only touches channel 2
    assert frac[0, 0] == 0.0 and frac[0, 1] == 0.0 and frac[0, 2] > 0.0


def test_compact_mcm_rgb():
    """RGB MCM compaction: hit pixels match the full kernel for the same
    seeds (same chains; compiled-program fusion differences leave ~1e-7
    float noise, like the spectral case), miss pixels equal the converged
    env expectation."""
    from vpt_tpu.models import mcm as MM
    from vpt_tpu.utils.config import MCMConfig

    env = _envmap(9)
    kw = dict(volume=Volume.sphere_in_cube(16), environment=env,
              config=MCMConfig(extinction=30.0, bounces=4, steps=6),
              resolution=RES)
    full = MM.MCMRenderer(**kw)
    comp = MM.MCMRenderer(**kw, compaction=True)
    cam = Camera()
    seeds = [(k + 1) * 2654435761 % 2**32 for k in range(10)]

    sf = full.reset(cam, seeds[0])
    sf, img_full = full.render_many(sf, cam, seeds)
    sc = comp.reset(cam, seeds[0])
    sc, img_comp = comp.render_many(sc, cam, seeds)
    hit = np.asarray(comp._compact_tables(cam)["hit"])
    np.testing.assert_allclose(np.asarray(img_comp)[hit],
                               np.asarray(img_full)[hit],
                               rtol=1e-5, atol=1e-6)

    def converged(seed0):
        s = full.reset(cam, seed0)
        s, img = full.render_many(
            s, cam, [(seed0 + k + 1) * 2654435761 % 2**32
                     for k in range(150)])
        return np.asarray(img)

    a, b = converged(1), converged(991)
    miss = ~hit
    assert miss.any()
    floor = np.abs(a[miss] - b[miss]).mean()
    diff = np.abs(np.asarray(img_comp)[miss] - a[miss]).mean()
    assert diff < 2.0 * floor + 1e-4, (diff, floor)


def test_compact_cache_bounded_and_bucketed():
    """Rendering many poses keeps the per-pose cache at its LRU bound,
    and nearby poses share one lane-array shape via row bucketing (no
    per-pose re-jit)."""
    from vpt_tpu.scene.camera import OrbitController

    _, comp = _renderers(streams=1)
    shapes = set()
    for k in range(12):
        cam = Camera()
        OrbitController(yaw=2 * np.pi * k / 12, pitch=-0.3).apply(cam)
        t = comp._compact_tables(cam)
        shapes.add(tuple(np.asarray(t["lane_ix"]).shape))
    assert len(comp._compact_cache) <= comp.COMPACT_CACHE_POSES
    # 12 orbit poses of the same scene should collapse to very few shapes
    assert len(shapes) <= 3, shapes


def test_compaction_config_errors():
    """Invalid compaction combinations raise ValueError (not assert) and
    the CLI rejects --compaction for renderers without a compact mode."""
    from vpt_tpu import cli

    table = np.zeros((256, 256, 4), np.float32)
    with pytest.raises(ValueError):
        M.MCMSpectralRenderer(
            Volume.sphere_in_cube(16), MaterialTF(table),
            LightConfig(), SpectrumConfig(),
            MCMSpectralConfig(extinction=30.0, blur=0.1),
            resolution=RES, compaction=True)
    with pytest.raises(SystemExit):
        cli.main(["render", "--renderer", "eam", "--compaction",
                  "--volume-size", "8", "--resolution", "8",
                  "--frames", "1", "-o", "/tmp/should_not_exist.npy"])
