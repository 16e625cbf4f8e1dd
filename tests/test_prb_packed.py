"""Packed-adjoint backward vs the raw-table replay backward.

Both paths are the SAME estimator (identical forward RNG consumption and
identical per-event analytic terms); only the scatter addressing differs
(packed corner rows + dense pack transposes vs raw-texel scatters). Per
seed the raw-table gradients must therefore agree to float rounding.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from vpt_tpu.kernels.spectral_backward import prb_render_and_grads
from vpt_tpu.models import mcm_spectral as M
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import (
    LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig,
)

RES = 16
STEPS = 8


def _renderers(volume, streams=1, big_volume=False):
    """(raw, packed) renderer pair over the same scene."""
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.7
    table[..., 1] = 0.1 + 0.8 * dens
    table[..., 2] = 0.3 + 0.4 * dens
    mat = MaterialTF(table)
    light = LightConfig(direction=(0.6, 0.3, 0.2))
    cfg = MCMSpectralConfig(extinction=6.0, bounces=4, steps=STEPS)
    kw = dict(resolution=RES, streams=streams)
    raw = M.MCMSpectralRenderer(volume, mat, light, SpectrumConfig(), cfg,
                                pack_tables=False, **kw)
    pack = (
        {"density_xy", "material_tf", "light_spectrum"} if big_volume else True
    )
    packed = M.MCMSpectralRenderer(volume, mat, light, SpectrumConfig(), cfg,
                                   pack_tables=pack, **kw)
    return raw, packed


def _grads(r, seed, g_img):
    cam = Camera()
    ctx = r.ctx(cam, seed)
    s0 = r.reset(cam, seed)
    state, img, grads = prb_render_and_grads(s0, ctx, g_img, STEPS, 12)
    return np.asarray(img), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("streams", [1, 2])
def test_packed_matches_raw_per_seed(streams):
    raw, packed = _renderers(Volume.sphere_in_cube(16), streams=streams)
    g_img = jnp.ones((RES, RES, 3))
    img_r, g_r = _grads(raw, 5, g_img)
    img_p, g_p = _grads(packed, 5, g_img)
    np.testing.assert_array_equal(img_r, img_p)  # forward bit-identical
    for k in ("density", "material_tf", "light_spectrum", "extinction"):
        a, b = g_r[k], g_p[k]
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-5,
                                   err_msg=k)
        assert np.abs(a).sum() > 0, f"{k} gradient is non-trivial"


def test_xy_packed_matches_raw():
    """The big-volume (xy half-packed) mode gets the same gradients."""
    raw, packed = _renderers(Volume.sphere_in_cube(16), big_volume=True)
    g_img = jnp.ones((RES, RES, 3))
    img_r, g_r = _grads(raw, 9, g_img)
    img_p, g_p = _grads(packed, 9, g_img)
    np.testing.assert_array_equal(img_r, img_p)
    for k in ("density", "material_tf", "light_spectrum", "extinction"):
        a, b = g_r[k], g_p[k]
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-5,
                                   err_msg=k)


def test_wrt_subsets():
    """wrt restricts the returned grads; values match the full run."""
    _, packed = _renderers(Volume.sphere_in_cube(16))
    g_img = jnp.ones((RES, RES, 3))
    cam = Camera()
    ctx = packed.ctx(cam, 7)
    s0 = packed.reset(cam, 7)
    _, _, g_all = prb_render_and_grads(s0, ctx, g_img, STEPS, 12)
    _, _, g_d = prb_render_and_grads(packed.reset(cam, 7), ctx, g_img,
                                     STEPS, 12, wrt=frozenset({"density"}))
    assert set(g_d) == {"density"}
    np.testing.assert_allclose(np.asarray(g_d["density"]),
                               np.asarray(g_all["density"]), rtol=1e-6)
    _, _, g_t = prb_render_and_grads(
        packed.reset(cam, 7), ctx, g_img, STEPS, 12,
        wrt=frozenset({"material_tf", "light_spectrum"}))
    assert set(g_t) == {"material_tf", "light_spectrum"}
    np.testing.assert_allclose(np.asarray(g_t["material_tf"]),
                               np.asarray(g_all["material_tf"]), rtol=1e-6)


def test_scatter_stride_partition_identity():
    """stride-k thinning at a FIXED seed: the k phase gradients partition
    the steps, so their average equals the exact gradient identically —
    pinning unbiasedness without statistics."""
    _, packed = _renderers(Volume.sphere_in_cube(16))
    g_img = jnp.ones((RES, RES, 3))
    cam = Camera()
    k = 4
    ctx = packed.ctx(cam, 7)
    _, _, g_e = prb_render_and_grads(packed.reset(cam, 7), ctx, g_img,
                                     STEPS, 12, wrt=frozenset({"density"}))
    exact = np.asarray(g_e["density"])
    acc = np.zeros_like(exact)
    for phase in range(k):
        _, _, g_s = prb_render_and_grads(
            packed.reset(cam, 7), ctx, g_img, STEPS, 12,
            wrt=frozenset({"density"}), scatter_stride=k,
            scatter_phase=phase)
        acc += np.asarray(g_s["density"]) / k
    scale = max(np.abs(exact).max(), 1e-6)
    np.testing.assert_allclose(acc / scale, exact / scale, atol=1e-5)
    assert np.abs(exact).sum() > 0


def test_rejects_half_packed_ctx():
    """TF packed but volume raw (or vice versa) is an explicit error, not a
    silent wrong answer."""
    vol = Volume.sphere_in_cube(16)
    r = M.MCMSpectralRenderer(
        vol, MaterialTF.constant(0.5, 0.5), LightConfig(), SpectrumConfig(),
        MCMSpectralConfig(extinction=4.0, steps=STEPS), resolution=RES,
        pack_tables={"material_tf", "light_spectrum"},
    )
    cam = Camera()
    ctx = r.ctx(cam, 1)
    s0 = r.reset(cam, 1)
    with pytest.raises(ValueError, match="packed"):
        prb_render_and_grads(s0, ctx, jnp.ones((RES, RES, 3)), STEPS, 12)


def test_many_matches_sequential_dispatches():
    """prb_render_and_grads_many(window=False) == K sequential
    prb_render_and_grads calls with summed grads, bit-for-bit (stride 1,
    per-dispatch m_final, score chains truncated at dispatch boundaries —
    the per-dispatch-optimizer composition)."""
    from vpt_tpu.kernels.spectral_backward import prb_render_and_grads_many

    _, packed = _renderers(Volume.sphere_in_cube(16), streams=2)
    g_img = jnp.ones((RES, RES, 3))
    cam = Camera()
    seeds = [11, 5021, 90001]
    wrt = frozenset({"density", "extinction"})

    state = packed.reset(cam, 3)
    want = None
    for s in seeds:
        state, _, g = prb_render_and_grads(
            state, packed.ctx(cam, s), g_img, STEPS, 12, wrt=wrt)
        want = g if want is None else {
            k: want[k] + g[k] for k in want}
    img_seq = np.asarray(M.radiance_to_rgb(state.radiance,
                                           packed.ctx(cam, 0).bin_xyz))

    s0 = packed.reset(cam, 3)
    state_m, img_m, got = prb_render_and_grads_many(
        s0, packed.ctx(cam, 0), jnp.asarray(seeds, jnp.uint32), g_img,
        STEPS, 12, wrt=wrt, window=False)
    np.testing.assert_array_equal(np.asarray(img_m), img_seq)
    for k in wrt:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        scale = max(np.abs(a).max(), 1e-6)
        # scan accumulates adjoints into the carry; sequential sums whole
        # per-dispatch grads — same values, different float association
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-5,
                                   err_msg=k)


def test_loss_and_grads_matches_manual_composition():
    """prb_loss_and_grads == render_many-derived (m_final, image, g_image)
    fed through spectral_backward_packed per dispatch in REVERSE order,
    threading the deposit-cotangent carry across dispatch boundaries (the
    window-exact composition)."""
    from vpt_tpu.kernels.spectral_backward import (
        prb_loss_and_grads, spectral_backward_packed)

    _, packed = _renderers(Volume.sphere_in_cube(16))
    cam = Camera()
    seeds = jnp.asarray([3, 77, 901, 40009], jnp.uint32)
    target = jnp.full((RES, RES, 3), 0.25)
    wrt = frozenset({"density"})

    import jax

    ctx = packed.ctx(cam, 1)
    starts, state = [], packed.reset(cam, 1)
    for s in np.asarray(seeds):
        # M.render donates its state arg; keep an undonated copy
        starts.append(jax.tree.map(jnp.array, state))
        state, _ = M.render(state, ctx._replace(seed_bits=jnp.uint32(s)),
                            steps=STEPS, n_bins=12)
    state_f, image = M.render_many(packed.reset(cam, 1), ctx, seeds,
                                   steps=STEPS, n_bins=12)
    np.testing.assert_array_equal(
        np.asarray(M.radiance_to_rgb(state.radiance, ctx.bin_xyz)),
        np.asarray(image))
    m_final = jnp.maximum(state_f.samples, 1).astype(jnp.float32)
    g_image = 2.0 * (image - target) / jnp.float32(image.size)
    want = None
    cot = dict(c=jnp.zeros_like(state.px), cb=jnp.zeros_like(state.px))
    for s, st in zip(np.asarray(seeds)[::-1], starts[::-1]):
        _, _, g, cot = spectral_backward_packed(
            st, ctx._replace(seed_bits=jnp.uint32(s)), g_image, STEPS, 12,
            wrt=wrt, m_final=m_final, cot_in=cot, return_cot=True)
        want = g if want is None else {k: want[k] + g[k] for k in want}

    _, img2, loss, got = prb_loss_and_grads(
        packed.reset(cam, 1), ctx, seeds, target, STEPS, 12, wrt=wrt)
    np.testing.assert_array_equal(np.asarray(img2), np.asarray(image))
    assert float(loss) == pytest.approx(float(jnp.mean((image - target) ** 2)))
    a, b = np.asarray(want["density"]), np.asarray(got["density"])
    scale = max(np.abs(a).max(), 1e-6)
    np.testing.assert_allclose(a / scale, b / scale, atol=1e-6)


def test_window_matches_autodiff_multi_dispatch():
    """THE window-correctness pin: prb_loss_and_grads over a K>1 dispatch
    window must equal jax.grad of the autodiff surrogate loss
    (optim.spectral_render_loss) PER SEED, with scattering on. This is
    exactly what per-dispatch truncation breaks: at this extinction paths
    span dispatch boundaries, and dropping their cross-dispatch score
    terms measured corr ~0.1 / ~7x norm loss against autodiff before the
    carry-threading fix.

    The TF's anisotropy channel is density-CONSTANT here: PRB and the
    surrogate use different (both unbiased) estimators for the HG term,
    and a density-dependent g channel leaks that difference into density
    grads via the g-slope chain — per-seed equality pins the alpha/albedo
    chains (the dominant terms) exactly."""
    import jax

    from vpt_tpu import optim
    from vpt_tpu.kernels.spectral_backward import prb_loss_and_grads

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.7
    table[..., 1] = 0.1 + 0.8 * dens
    table[..., 2] = 0.5  # g = 0, density-constant
    mat = MaterialTF(table)
    light = LightConfig(direction=(0.6, 0.3, 0.2))
    cfg = MCMSpectralConfig(extinction=6.0, bounces=4, steps=STEPS)
    vol = Volume.sphere_in_cube(16)
    kw = dict(resolution=RES, streams=2)
    raw = M.MCMSpectralRenderer(vol, mat, light, SpectrumConfig(), cfg,
                                pack_tables=False, **kw)
    packed = M.MCMSpectralRenderer(vol, mat, light, SpectrumConfig(), cfg,
                                   pack_tables=True, **kw)
    cam = Camera()
    seeds = jnp.asarray([8, 5100, 77, 90017], jnp.uint32)
    target = jnp.full((RES, RES, 3), 0.25)
    params = {"density": jnp.asarray(np.asarray(
        Volume.sphere_in_cube(16).density))}

    ctx_raw = raw.ctx(cam, 7)
    loss_a, g_a = jax.value_and_grad(optim.spectral_render_loss)(
        params, raw.reset(cam, 7), ctx_raw, seeds, target, STEPS, 12, False)

    ctx_pk = packed.ctx(cam, 7)
    _, _, loss_p, g_p = prb_loss_and_grads(
        packed.reset(cam, 7), ctx_pk, seeds, target, STEPS, 12,
        wrt=frozenset({"density"}), scatter_stride=1)

    assert float(loss_p) == pytest.approx(float(loss_a), rel=1e-5)
    a, b = np.asarray(g_a["density"]), np.asarray(g_p["density"])
    scale = max(np.abs(a).max(), 1e-6)
    np.testing.assert_allclose(b / scale, a / scale, atol=5e-4)
    assert np.abs(a).sum() > 0


def test_fit_spectral_prb_recovers_alpha():
    """End-to-end config-4 shape on the PRB fast path: recover a TF alpha
    from a packed-tables renderer (the default method auto-selects prb)."""
    from vpt_tpu.optim import fit_spectral
    from vpt_tpu.utils.config import MaterialTF as MTF

    def renderer(alpha):
        vol = Volume(density=np.full((4, 4, 4), 0.5, np.float32))
        mat = MTF.constant(albedo=0.0, alpha=alpha)
        light = LightConfig(direction=(0.0, 0.0, 0.0))
        cfg = MCMSpectralConfig(extinction=2.0, bounces=0, steps=8)
        return M.MCMSpectralRenderer(vol, mat, light, SpectrumConfig(), cfg,
                                     resolution=RES, pack_tables=True)

    true_alpha = 0.6
    r = renderer(true_alpha)
    cam = Camera()
    state = r.reset(cam, 5)
    seeds = [np.uint32((5 + k + 1) * 2654435761 % 2**32) for k in range(64)]
    state, target = r.render_many(state, cam, seeds)

    r2 = renderer(0.2)
    params, losses = fit_spectral(
        np.asarray(target), r2, cam,
        {"material_tf": r2.material_tf.table.copy()},
        dispatches_per_step=6, iterations=120, learning_rate=0.05, seed=11,
        scatter_stride=2,
    )
    mt = np.asarray(params["material_tf"])
    rec_alpha = float(mt[127:129, :, 1].mean())
    untouched = float(mt[0:100, :, 1].mean())
    assert losses[-1] < losses[0], f"loss did not drop: {losses[0]} -> {losses[-1]}"
    assert rec_alpha > 0.4, f"alpha barely moved: {rec_alpha}"
    assert abs(rec_alpha - true_alpha) < abs(0.2 - true_alpha)
    assert untouched == pytest.approx(0.2, abs=1e-5)


@pytest.mark.parametrize("filt", ["linear", "quasicubic"])
def test_packed_matches_raw_across_filters(filt):
    """Filter x gradient matrix: the packed backward supports the
    smoothstep-warped quasicubic filter (corner cotangents = warped
    weights; quasiCubicSampling.glsl:3-9) and matches the raw replay
    backward per seed."""
    from vpt_tpu.scene.volume import Volume as V

    vol = V(density=np.asarray(V.sphere_in_cube(16).density), filter=filt)
    raw, packed = _renderers(vol)
    g_img = jnp.ones((RES, RES, 3))

    def grads_of(r, seed):
        cam = Camera()
        ctx = r.ctx(cam, seed)
        s0 = r.reset(cam, seed)
        state, img, g = prb_render_and_grads(s0, ctx, g_img, STEPS, 12,
                                             volume_filter=filt)
        return np.asarray(img), {k: np.asarray(v) for k, v in g.items()}

    img_r, g_r = grads_of(raw, 13)
    img_p, g_p = grads_of(packed, 13)
    np.testing.assert_array_equal(img_r, img_p)
    for k in ("density", "material_tf", "extinction"):
        a, b = g_r[k], g_p[k]
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-5,
                                   err_msg=f"{filt}:{k}")
        assert np.abs(a).sum() > 0


@pytest.mark.parametrize("filt", ["linear", "quasicubic"])
def test_packed_grad_matches_autodiff_per_seed_no_scatter(filt):
    """With albedo = 0 and bounces = 0 there are no scatter events, so the
    PRB and the autodiff-surrogate estimators coincide term-by-term (both
    use score-form free flights and event scores; the HG pathwise-vs-score
    divergence never fires) — density gradients must match PER SEED to
    float tolerance. This pins the quasicubic corner-weight warp sharply:
    an unwarped (linear) backward weight under a warped forward fails."""
    import jax

    from vpt_tpu.models.mcm_spectral import render_sequence_diff
    from vpt_tpu.scene.volume import Volume as V

    vol = V(density=np.asarray(V.sphere_in_cube(12).density), filter=filt)
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 1] = 0.1 + 0.8 * dens  # alpha ramp, albedo 0, g 0.5 -> 0
    table[..., 2] = 0.5
    mat = MaterialTF(table)
    # isotropic light: with bounces=0 rays never turn, and a directional
    # light behind the camera would zero every through-material deposit
    # (leaving only clamp-dead-zone paths -> a correctly-zero density grad)
    light = LightConfig(direction=(0.0, 0.0, 0.0))
    cfg = MCMSpectralConfig(extinction=6.0, bounces=0, steps=STEPS)
    raw = M.MCMSpectralRenderer(vol, mat, light, SpectrumConfig(), cfg,
                                resolution=RES, pack_tables=False)
    packed = M.MCMSpectralRenderer(vol, mat, light, SpectrumConfig(), cfg,
                                   resolution=RES, pack_tables=True)
    cam = Camera()
    for seed in (4, 321):
        ctx = packed.ctx(cam, seed)
        s0 = packed.reset(cam, seed)
        g_img = jnp.ones((RES, RES, 3))
        _, _, g = prb_render_and_grads(s0, ctx, g_img, STEPS, 12,
                                       volume_filter=filt,
                                       wrt=frozenset({"density"}))
        g_prb = np.asarray(g["density"])

        rctx = raw.ctx(cam, seed)
        rs0 = raw.reset(cam, seed)

        def img_sum(d):
            img = render_sequence_diff(
                jnp.asarray([np.uint32(seed)], jnp.uint32), rs0,
                rctx._replace(density=d), STEPS, 12, volume_filter=filt)
            return jnp.sum(img)

        g_ad = np.asarray(jax.grad(img_sum)(jnp.asarray(vol.density)))
        scale = max(np.abs(g_ad).max(), 1e-6)
        np.testing.assert_allclose(g_prb / scale, g_ad / scale, atol=5e-4,
                                   err_msg=f"{filt} seed {seed}")
        assert np.abs(g_ad).sum() > 0


def test_environment_gradients_match_autodiff_per_seed():
    """Differentiable environment escape (the reference's dormant env path,
    MCMSpectralComputeRenderer.wgsl:49-60): pathwise texel gradients through
    the equirect bilinear lookup. With albedo=0/bounces=0 the PRB and
    autodiff estimators coincide per seed (no HG divergence), so both the
    env and density gradients must match to float tolerance."""
    import jax

    from vpt_tpu.models.mcm_spectral import render_sequence_diff
    from vpt_tpu.scene.volume import Volume as V

    vol = V(density=np.asarray(V.sphere_in_cube(12).density))
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 1] = 0.1 + 0.6 * dens
    table[..., 2] = 0.5
    mat = MaterialTF(table)
    light = LightConfig(direction=(0.0, 0.0, 0.0))
    cfg = MCMSpectralConfig(extinction=6.0, bounces=0, steps=STEPS)
    rng = np.random.default_rng(8)
    env = rng.uniform(0.1, 1.0, (8, 16, 3)).astype(np.float32)

    raw = M.MCMSpectralRenderer(vol, mat, light, SpectrumConfig(), cfg,
                                resolution=RES, pack_tables=False,
                                environment=env)
    packed = M.MCMSpectralRenderer(vol, mat, light, SpectrumConfig(), cfg,
                                   resolution=RES, pack_tables=True,
                                   environment=env)
    assert packed.ctx(Camera(), 0).environment.shape == (9, 17, 12)
    cam = Camera()
    for seed in (2, 77):
        ctx = packed.ctx(cam, seed)
        s0 = packed.reset(cam, seed)
        g_img = jnp.ones((RES, RES, 3))
        _, _, g = prb_render_and_grads(
            s0, ctx, g_img, STEPS, 12,
            wrt=frozenset({"environment", "density"}))
        rctx = raw.ctx(cam, seed)
        rs0 = raw.reset(cam, seed)

        def img_sum(e, d):
            img = render_sequence_diff(
                jnp.asarray([np.uint32(seed)], jnp.uint32), rs0,
                rctx._replace(environment=e, density=d), STEPS, 12)
            return jnp.sum(img)

        g_env_ad, g_d_ad = jax.grad(img_sum, argnums=(0, 1))(
            jnp.asarray(env), jnp.asarray(vol.density))
        for name, a, b in (("environment", np.asarray(g_env_ad),
                            np.asarray(g["environment"])),
                           ("density", np.asarray(g_d_ad),
                            np.asarray(g["density"]))):
            scale = max(np.abs(a).max(), 1e-6)
            np.testing.assert_allclose(b / scale, a / scale, atol=5e-4,
                                       err_msg=f"{name} seed {seed}")
            assert np.abs(a).sum() > 0, name


def test_window_storage_modes_agree():
    """window_storage="tape" (one taped forward sweep) and "forward"
    (start-state re-simulate) are the same estimator computed two ways —
    image bit-identical, grads equal to float rounding."""
    from vpt_tpu.kernels.spectral_backward import prb_render_and_grads_many

    _, packed = _renderers(Volume.sphere_in_cube(16), streams=2)
    cam = Camera()
    seeds = jnp.asarray([11, 5021, 90001, 7], jnp.uint32)
    g_img = jnp.ones((RES, RES, 3))
    wrt = frozenset({"density", "extinction"})
    out = {}
    for storage in ("tape", "forward"):
        s0 = packed.reset(cam, 3)
        state, img, g = prb_render_and_grads_many(
            s0, packed.ctx(cam, 0), seeds, g_img, STEPS, 12, wrt=wrt,
            window_storage=storage)
        out[storage] = (np.asarray(img), {k: np.asarray(v)
                                          for k, v in g.items()})
    np.testing.assert_array_equal(out["tape"][0], out["forward"][0])
    for k in wrt:
        a, b = out["tape"][1][k], out["forward"][1][k]
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-6,
                                   err_msg=k)


def test_importance_thinning_unbiased_and_deterministic():
    """Importance-thinned scatters: per pick-seed the
    estimator is random, but its mean over pick seeds equals the exact
    (stride 1) gradient — standard importance sampling of the per-step
    scatter sum with weights S/(m|q|). Also: identical pick_bits give
    identical results (counter-based pick RNG)."""
    import jax.numpy as jnp

    _, packed = _renderers(Volume.sphere_in_cube(8))
    cam = Camera()
    seed = 3
    ctx = packed.ctx(cam, seed)
    g_img = jnp.ones((RES, RES, 3), jnp.float32)

    s0 = packed.reset(cam, seed)
    _, _, exact = prb_render_and_grads(s0, ctx, g_img, STEPS, 12,
                                       wrt=frozenset({"density"}))
    exact_d = np.asarray(exact["density"])

    def imp(pick_seed):
        s0 = packed.reset(cam, seed)
        _, _, g = prb_render_and_grads(
            s0, ctx, g_img, STEPS, 12, wrt=frozenset({"density"}),
            scatter_stride=4, scatter_mode="importance",
            pick_bits=jnp.uint32(pick_seed))
        return np.asarray(g["density"])

    a = imp(12345)
    b = imp(12345)
    np.testing.assert_array_equal(a, b)  # deterministic given pick_bits

    n = 200
    sums = []
    acc = np.zeros_like(exact_d)
    for k in range(n):
        g = imp((k + 1) * 2654435761 % 2**32)
        acc += g
        sums.append(g.sum())
    mean = acc / n
    se = np.std(sums) / np.sqrt(n)
    assert abs(mean.sum() - exact_d.sum()) < 4 * se + 1e-6, (
        mean.sum(), exact_d.sum(), se)
    # elementwise: the mean must track the exact gradient's structure
    num = float((mean * exact_d).sum())
    den = float(np.linalg.norm(mean) * np.linalg.norm(exact_d))
    assert num / max(den, 1e-30) > 0.95

    # the light-spectrum term is the one a naive |q| selection metric
    # would BIAS (its scatter scales with the cotangent alone — an
    # escaping path with zero contribution still carries light gradient);
    # pin its unbiasedness under the table-magnitude metric
    wrt_tf = frozenset({"material_tf", "light_spectrum"})
    s0 = packed.reset(cam, seed)
    _, _, exact_tf = prb_render_and_grads(s0, ctx, g_img, STEPS, 12,
                                          wrt=wrt_tf)
    exact_ls = np.asarray(exact_tf["light_spectrum"])

    def imp_ls(pick_seed):
        s0 = packed.reset(cam, seed)
        _, _, g = prb_render_and_grads(
            s0, ctx, g_img, STEPS, 12, wrt=wrt_tf,
            scatter_stride=4, scatter_mode="importance",
            pick_bits=jnp.uint32(pick_seed))
        return np.asarray(g["light_spectrum"])

    n2 = 150
    sums2, acc2 = [], np.zeros_like(exact_ls)
    for k in range(n2):
        g = imp_ls((k + 11) * 2654435761 % 2**32)
        acc2 += g
        sums2.append(g.sum())
    se2 = np.std(sums2) / np.sqrt(n2)
    assert abs(acc2.sum() / n2 - exact_ls.sum()) < 4 * se2 + 1e-7, (
        acc2.sum() / n2, exact_ls.sum(), se2)


def test_importance_thinning_in_window_and_fit():
    """scatter_mode='importance' composes with the K-dispatch window and
    the optimizer step (finite loss, params move)."""
    import jax.numpy as jnp
    import optax

    from vpt_tpu import optim
    from vpt_tpu.kernels.spectral_backward import prb_loss_and_grads

    _, packed = _renderers(Volume.sphere_in_cube(8))
    cam = Camera()
    ctx = packed.ctx(cam, 1)
    s0 = packed.reset(cam, 1)
    target = jnp.zeros((RES, RES, 3), jnp.float32)
    seeds = jnp.asarray([5, 6, 7, 8], jnp.uint32)
    _, _, loss, g = prb_loss_and_grads(
        s0, ctx, seeds, target, STEPS, 12, wrt=frozenset({"density"}),
        scatter_stride=4, scatter_mode="importance")
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(g["density"])).all()
    assert np.abs(np.asarray(g["density"])).max() > 0

    step = optim.make_spectral_prb_step(
        optax.adam(0.02), STEPS, 12, wrt=frozenset({"density"}),
        scatter_stride=4, scatter_mode="importance")
    init = {"density": jnp.asarray(Volume.sphere_in_cube(8).density)}
    istate = optim.InverseState(init, optax.adam(0.02).init(init),
                                jnp.zeros((), jnp.int32))
    istate, l2 = step(istate, packed.reset(cam, 1), ctx, seeds, target)
    assert np.isfinite(float(l2))
