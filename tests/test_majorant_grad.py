"""Majorant-mode gradients: the super-voxel accelerator's
autodiff surrogate must agree with central finite differences of its own
seed-averaged image, with common random numbers — the same statistical
protocol as tests/test_grad_fd.py, under ctx.majorant.

Estimator notes pinned here:
  - the local sampling rate extinction * m treats m as a DETACHED
    sampling-distribution choice (any valid bound has the same
    expectation); a capped flight contributes the log-survival term, an
    uncapped one the collision density — both ride the score weight;
  - the acceptance wheel's alpha/m keeps alpha differentiable (the
    TF -> density chain), so density/TF gradients flow exactly as in the
    reference-exact wheel;
  - the majorant table must remain a TRUE bound for the perturbed params
    (delta tracking's validity condition) — the fixture builds it with
    safety headroom so the FD eps stays inside the bound.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vpt_tpu.models import mcm_spectral as M
from vpt_tpu.ops.majorant import build_majorant_grid
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import (
    LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig,
)

RES = 8
STEPS = 64
NBINS = 12
N_FD_SEEDS = 768
N_AD_SEEDS = 192


@pytest.fixture(scope="module")
def majorant_ctx():
    """Full-support scene (alpha in (0, 1)) with a super-voxel majorant
    built with 30% safety headroom so the FD perturbations stay bounded."""
    vol = Volume.sphere_in_cube(8)
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.7
    table[..., 1] = 0.1 + 0.8 * dens
    table[..., 2] = 0.6
    mat = MaterialTF(table)
    light = LightConfig(direction=(0.0, 0.0, 0.0))
    cfg = MCMSpectralConfig(extinction=4.0, bounces=3, steps=STEPS)
    r = M.MCMSpectralRenderer(vol, mat, light, SpectrumConfig(), cfg,
                              resolution=RES, pack_tables=False)
    maj = build_majorant_grid(vol.density, table, cfg.extinction, block=4,
                              safety=0.3)
    return r.ctx(Camera(), 0)._replace(majorant=jnp.asarray(maj))


def _seeds(n):
    return (jnp.arange(1, n + 1, dtype=jnp.uint32) * jnp.uint32(2654435761))


def _render_sum(ctx, seed_bits):
    c = ctx._replace(seed_bits=seed_bits)
    state = M.full_reset(c, RES, NBINS)
    _, img = M.render(state, c, steps=STEPS, n_bins=NBINS)
    return jnp.sum(img)


@jax.jit
def _per_seed_sums(ctx, seeds):
    def body(_, s):
        return None, _render_sum(ctx, s)

    _, vals = jax.lax.scan(body, None, seeds)
    return vals


@jax.jit
def _ad_grad_mean(ctx, seeds):
    def one(seed_bits):
        def loss(dens, tf, ext):
            c = ctx._replace(density=dens, material_tf=tf, extinction=ext,
                             seed_bits=seed_bits)
            s0 = M.full_reset(c, RES, NBINS)
            score = jnp.ones_like(s0.px)
            _, _, img = M.render_diff(s0, score, c, STEPS, NBINS)
            return jnp.sum(img)

        return jax.grad(loss, argnums=(0, 1, 2))(
            ctx.density, ctx.material_tf, ctx.extinction)

    def body(acc, s):
        return jax.tree.map(jnp.add, acc, one(s)), None

    z = (jnp.zeros_like(ctx.density), jnp.zeros_like(ctx.material_tf),
         jnp.float32(0.0))
    tot, _ = jax.lax.scan(body, z, seeds)
    return jax.tree.map(lambda x: x / seeds.shape[0], tot)


def _fd_directional(ctx, field, direction, eps):
    seeds = _seeds(N_FD_SEEDS)
    if field == "extinction":
        cp = ctx._replace(extinction=ctx.extinction + eps)
        cm = ctx._replace(extinction=ctx.extinction - eps)
    else:
        cp = ctx._replace(**{field: getattr(ctx, field) + eps * direction})
        cm = ctx._replace(**{field: getattr(ctx, field) - eps * direction})
    diffs = (np.asarray(_per_seed_sums(cp, seeds))
             - np.asarray(_per_seed_sums(cm, seeds))) / (2 * eps)
    return float(diffs.mean()), float(diffs.std() / np.sqrt(len(diffs)))


@pytest.fixture(scope="module")
def ad_means(majorant_ctx):
    gd, gt, ge = _ad_grad_mean(majorant_ctx, _seeds(N_AD_SEEDS))
    return dict(density=np.asarray(gd), material_tf=np.asarray(gt),
                extinction=float(ge))


def _assert_close(name, fd, se, val):
    tol = 4 * se + 0.15 * max(abs(fd), abs(val))
    assert abs(fd - val) < tol, (
        f"{name}: FD {fd:.4f}±{se:.4f} vs AD {val:.4f} (tol {tol:.4f})")


def test_fd_majorant_density(majorant_ctx, ad_means):
    d = jnp.ones_like(majorant_ctx.density)
    fd, se = _fd_directional(majorant_ctx, "density", d, 0.03)
    _assert_close("density", fd, se, float(ad_means["density"].sum()))


def test_fd_majorant_tf_alpha(majorant_ctx, ad_means):
    d = jnp.zeros_like(majorant_ctx.material_tf).at[..., 1].set(1.0)
    fd, se = _fd_directional(majorant_ctx, "material_tf", d, 0.03)
    _assert_close("tf_alpha", fd, se,
                  float(ad_means["material_tf"][..., 1].sum()))


def test_fd_majorant_extinction(majorant_ctx, ad_means):
    fd, se = _fd_directional(majorant_ctx, "extinction", None, 0.25)
    assert se < 0.5 * abs(fd) + 0.2
    _assert_close("extinction", fd, se, ad_means["extinction"])


def test_majorant_matches_exact_gradient_in_expectation(majorant_ctx):
    """Both modes estimate gradients of the SAME image function, so their
    seed-averaged density gradients must agree statistically (a cross-
    estimator consistency check the per-mode FD tests cannot provide)."""
    exact_ctx = majorant_ctx._replace(majorant=None)
    gd_m, _, _ = _ad_grad_mean(majorant_ctx, _seeds(N_AD_SEEDS))
    gd_e, _, _ = _ad_grad_mean(exact_ctx, _seeds(N_AD_SEEDS) + 7919)
    a, b = float(jnp.sum(gd_m)), float(jnp.sum(gd_e))
    assert abs(a - b) < 0.25 * max(abs(a), abs(b)) + 0.05, (a, b)


def test_fit_spectral_majorant_routes_to_autodiff():
    """fit_spectral on a majorant renderer auto-selects the surrogate and
    rejects a forced prb method with a clear error."""
    from vpt_tpu import optim

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 1] = 0.1 + 0.8 * dens
    r = M.MCMSpectralRenderer(
        Volume.sphere_in_cube(8), MaterialTF(table),
        LightConfig(direction=(0.0, 0.0, 0.0)), SpectrumConfig(),
        MCMSpectralConfig(extinction=4.0, bounces=2, steps=4),
        resolution=RES, pack_tables=True, majorant_blocks=4)
    cam = Camera()
    s = r.reset(cam, 1)
    s, target = r.render_many(s, cam, [5, 6])
    init = np.full((8, 8, 8), 0.4, np.float32)
    with pytest.raises(ValueError):
        optim.fit_spectral(np.asarray(target), r, cam, {"density": init},
                           iterations=1, method="prb")
    _, losses, info = optim.fit_spectral(
        np.asarray(target), r, cam, {"density": init},
        iterations=2, dispatches_per_step=2, return_info=True)
    assert info["method"] == "autodiff"
    assert np.isfinite(losses).all()
