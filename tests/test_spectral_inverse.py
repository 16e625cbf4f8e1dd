"""Spectral inverse rendering (config 4): recover material parameters from a
target spectral render via the REINFORCE-surrogate gradients."""

import numpy as np
import pytest

import jax.numpy as jnp

from vpt_tpu.models import mcm_spectral as M
from vpt_tpu.optim import fit_spectral
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig

RES = 16


def _renderer(alpha):
    vol = Volume(density=np.full((4, 4, 4), 0.5, np.float32))
    mat = MaterialTF.constant(albedo=0.0, alpha=alpha)
    light = LightConfig(direction=(0.0, 0.0, 0.0))
    cfg = MCMSpectralConfig(extinction=2.0, bounces=0, steps=8)
    return M.MCMSpectralRenderer(vol, mat, light, SpectrumConfig(), cfg,
                                 resolution=RES, pack_tables=False)


def _converged_target(alpha, dispatches=64, seed=5):
    r = _renderer(alpha)
    cam = Camera()
    state = r.reset(cam, seed)
    seeds = [np.uint32((seed + k + 1) * 2654435761 % 2**32) for k in range(dispatches)]
    state, img = r.render_many(state, cam, seeds)
    return np.asarray(img)


def test_recover_alpha_from_spectral_target():
    """Start the TF alpha at the wrong value; the optimizer must move it
    toward the truth using score-function gradients."""
    true_alpha = 0.6
    target = _converged_target(true_alpha)

    r = _renderer(0.2)  # wrong initial alpha
    cam = Camera()
    init = {"material_tf": r.material_tf.table.copy()}
    params, losses = fit_spectral(
        target, r, cam, init, dispatches_per_step=6, iterations=120,
        learning_rate=0.05, seed=11,
    )
    mt = np.asarray(params["material_tf"])
    # the constant-density (0.5) volume only exercises TF rows 127/128 —
    # gradient lands there; other rows must be untouched
    rec_alpha = float(mt[127:129, :, 1].mean())
    untouched = float(mt[0:100, :, 1].mean())
    assert losses[-1] < losses[0], f"loss did not drop: {losses[0]} -> {losses[-1]}"
    assert rec_alpha > 0.4, f"alpha barely moved: {rec_alpha}"
    assert abs(rec_alpha - true_alpha) < abs(0.2 - true_alpha)
    assert untouched == pytest.approx(0.2, abs=1e-5)


def test_spectral_loss_gradient_is_stochastic_but_consistent():
    """Different sample streams give different losses but both finite."""
    import jax

    from vpt_tpu.optim import spectral_render_loss

    r = _renderer(0.5)
    cam = Camera()
    ctx = r.ctx(cam, 3)
    state0 = r.reset(cam, 3)
    target = jnp.zeros((RES, RES, 3))
    p = {"material_tf": jnp.asarray(r.material_tf.table)}

    for s in (1, 2):
        seeds = jnp.asarray([s * 7 + 1, s * 7 + 2], jnp.uint32)
        loss, g = jax.value_and_grad(spectral_render_loss)(
            p, state0, ctx, seeds, target, 4, 12
        )
        assert np.isfinite(float(loss))
        assert np.isfinite(np.asarray(g["material_tf"])).all()


def test_recover_environment_map_prb():
    """Recover an env map's color from a target render on the PRB fast path
    (wrt={'environment'}). A 1x1 env makes the problem well-conditioned
    (every escape constrains the same 3 texels; a many-texel equirect map
    seen through a narrow frustum is underdetermined — verified: autodiff
    and PRB walk identically there, it is the problem, not the estimator)."""
    import numpy as np

    from vpt_tpu.optim import fit_spectral

    def renderer(env):
        vol = Volume(density=np.zeros((4, 4, 4), np.float32))
        mat = MaterialTF.constant(albedo=0.0, alpha=0.0)
        cfg = MCMSpectralConfig(extinction=2.0, bounces=0, steps=4)
        return M.MCMSpectralRenderer(
            vol, mat, LightConfig(direction=(0.0, 0.0, 0.0)),
            SpectrumConfig(), cfg, resolution=RES, pack_tables=True,
            environment=env)

    true_env = np.asarray([[[0.8, 0.45, 0.2]]], np.float32)
    r = renderer(true_env)
    cam = Camera()
    state = r.reset(cam, 5)
    seeds = [np.uint32((5 + k + 1) * 2654435761 % 2**32) for k in range(64)]
    state, target = r.render_many(state, cam, seeds)

    init_env = np.full((1, 1, 3), 0.5, np.float32)
    r2 = renderer(init_env)
    params, losses = fit_spectral(
        np.asarray(target), r2, cam, {"environment": init_env.copy()},
        dispatches_per_step=8, iterations=100, learning_rate=0.02, seed=11,
        method="prb", scatter_stride=1,
    )
    rec = np.asarray(params["environment"])
    err0 = float(np.abs(init_env - true_env).mean())
    err1 = float(np.abs(rec - true_env).mean())
    assert err1 < 0.5 * err0, (true_env.ravel(), rec.ravel())


def test_fit_spectral_checkpoint_resume_bit_identical(tmp_path):
    """Interrupted-and-resumed optimization == straight-through run,
    bit-for-bit (per-iteration seeds derive from the iteration index;
    save/load round-trips the full (params, opt_state, step) pytree)."""
    import numpy as np

    from vpt_tpu.optim import fit_spectral

    def renderer(alpha):
        vol = Volume(density=np.full((4, 4, 4), 0.5, np.float32))
        mat = MaterialTF.constant(albedo=0.0, alpha=alpha)
        cfg = MCMSpectralConfig(extinction=2.0, bounces=0, steps=4)
        return M.MCMSpectralRenderer(
            vol, mat, LightConfig(direction=(0.0, 0.0, 0.0)),
            SpectrumConfig(), cfg, resolution=RES, pack_tables=True)

    target = np.zeros((RES, RES, 3), np.float32)
    kw = dict(dispatches_per_step=2, learning_rate=0.05, seed=9,
              method="prb")
    init = {"material_tf": renderer(0.4).material_tf.table.copy()}

    straight, _ = fit_spectral(target, renderer(0.4), Camera(), dict(init),
                               iterations=8, **kw)

    ck = str(tmp_path / "inv.npz")
    fit_spectral(target, renderer(0.4), Camera(), dict(init),
                 iterations=4, checkpoint=ck, checkpoint_every=2, **kw)
    resumed, losses2 = fit_spectral(target, renderer(0.4), Camera(),
                                    dict(init), iterations=8, checkpoint=ck,
                                    checkpoint_every=2, **kw)
    assert len(losses2) == 4  # only the resumed iterations
    np.testing.assert_array_equal(np.asarray(straight["material_tf"]),
                                  np.asarray(resumed["material_tf"]))


def test_sanitize_grads_bounds_spikes_and_kills_nan():
    """The MC score estimator has heavy tails: rare near-zero-probability
    events contribute ~1/p-scale terms that can overflow the scatter-add
    accumulation to inf, and Adam turns one inf gradient element into a NaN
    parameter. sanitize_grads is the optimizer-level guard (optim.py)."""
    from vpt_tpu.optim import sanitize_grads

    g = {"density": jnp.asarray([1e-3, np.inf, -np.inf, np.nan, 5e3, -5e3]),
         "extinction": jnp.asarray(2.0)}
    s = sanitize_grads(g, 1e3)
    np.testing.assert_allclose(
        np.asarray(s["density"]), [1e-3, 1e3, -1e3, 0.0, 1e3, -1e3])
    assert float(s["extinction"]) == 2.0
    # an inf gradient through vanilla Adam is exactly the failure mode:
    import optax
    opt = optax.adam(0.02)
    bad = {"d": jnp.asarray([np.inf, 1.0])}
    p = {"d": jnp.asarray([0.5, 0.5])}
    upd, _ = opt.update(bad, opt.init(p), p)
    assert np.isnan(np.asarray(optax.apply_updates(p, upd)["d"][0]))
    upd, _ = opt.update(sanitize_grads(bad, 1e3), opt.init(p), p)
    assert np.isfinite(np.asarray(optax.apply_updates(p, upd)["d"])).all()


def test_live_gradient_fraction_and_auto_stride():
    """The adaptive-stride probe: broad-support scenes get
    the thinned stride, concentrated-support scenes get the exact one —
    calibrated on the r4 study scenes' measured fractions."""
    from vpt_tpu.optim import auto_initial_stride, live_gradient_fraction

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)

    dense = np.random.default_rng(0).uniform(0.3, 1.0, (16, 16, 16))
    sparse = np.full((16, 16, 16), 0.1, np.float32)  # under the TF dead zone
    assert live_gradient_fraction(dense, table) > 0.9
    assert live_gradient_fraction(sparse, table) == 0.0
    s, f = auto_initial_stride(dense, table)
    assert s == 4 and f > 0.9
    s, f = auto_initial_stride(sparse, table)
    assert s == 1 and f == 0.0
    # a flat TF (zero alpha-slope everywhere) has no live voxels at all
    flat = np.full((256, 256, 4), 0.5, np.float32)
    assert live_gradient_fraction(dense, flat) == 0.0


def test_eval_stall_detector():
    from vpt_tpu.optim import EvalStallDetector

    d = EvalStallDetector(rel_improve=0.02, patience=2)
    assert not d.update(1.0)      # first value: becomes best
    assert not d.update(0.9)      # improving
    assert not d.update(0.895)    # < 2% improvement: strike 1
    assert d.update(0.894)        # strike 2 -> stall
    d2 = EvalStallDetector(rel_improve=0.02, patience=2)
    assert not d2.update(1.0)
    assert not d2.update(0.99)    # strike 1
    assert not d2.update(0.5)     # big improvement resets strikes
    assert not d2.update(0.499)   # strike 1 again
    assert d2.update(0.499)       # strike 2 -> stall


def test_fit_spectral_auto_stride_probe_and_anneal():
    """scatter_stride='auto' end-to-end: the packed-path fit picks the
    probe's stride, records it in info, and a constant-alpha (flat-slope)
    TF forces initial stride 1 without any annealing machinery."""
    from vpt_tpu.scene.volume import Volume as V

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    vol = V.sphere_in_cube(8)

    def packed_renderer(v):
        return M.MCMSpectralRenderer(
            v, MaterialTF(table), LightConfig(direction=(1.0, 0.2, 0.5)),
            SpectrumConfig(), MCMSpectralConfig(extinction=20.0, steps=8),
            resolution=RES, pack_tables=True)

    r = packed_renderer(vol)
    cam = Camera()
    s = r.reset(cam, 5)
    s, target = r.render_many(
        s, cam, [(5 + k + 1) * 2654435761 % 2**32 for k in range(8)])

    # dense-ish init (values inside the TF live zone) -> uniform stride 4
    dense_init = np.full(vol.density.shape, 0.6, np.float32)
    _, _, info = fit_spectral(
        np.asarray(target), packed_renderer(V(density=dense_init)), cam,
        {"density": dense_init}, iterations=2, dispatches_per_step=2,
        return_info=True)
    assert info["method"] == "prb"
    assert info["stride_history"][0] == (0, "stride:4")
    assert info["live_fraction"] > 0.9

    # init under the TF dead zone -> concentrated gradient support: the
    # probe routes to IMPORTANCE thinning at the same index budget
    sparse_init = np.full(vol.density.shape, 0.1, np.float32)
    _, _, info = fit_spectral(
        np.asarray(target), packed_renderer(V(density=sparse_init)), cam,
        {"density": sparse_init}, iterations=2, dispatches_per_step=2,
        return_info=True)
    assert info["stride_history"][0] == (0, "importance:4")
    assert info["final_stride"] == 4


def test_fit_spectral_warns_on_stride_fallback():
    """A user-requested stride that does not divide steps is lowered with a
    warning and recorded."""
    import warnings as W

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    vol = Volume.sphere_in_cube(8)
    r = M.MCMSpectralRenderer(
        vol, MaterialTF(table), LightConfig(direction=(1.0, 0.2, 0.5)),
        SpectrumConfig(), MCMSpectralConfig(extinction=20.0, steps=6),
        resolution=RES, pack_tables=True)
    cam = Camera()
    s = r.reset(cam, 5)
    s, target = r.render_many(s, cam, [11, 12])
    init = np.full(vol.density.shape, 0.6, np.float32)
    with W.catch_warnings(record=True) as caught:
        W.simplefilter("always")
        _, _, info = fit_spectral(
            np.asarray(target), r, cam, {"density": init}, iterations=1,
            dispatches_per_step=2, scatter_stride=4, return_info=True)
    assert any("largest divisor" in str(w.message) for w in caught)
    # largest divisor of 6 <= 4
    assert info["stride_history"][0] == (0, "stride:3")
