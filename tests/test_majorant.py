"""Super-voxel majorant grid (ops/majorant): bound invariants + image-level
statistical parity of the majorant render mode vs the reference-exact path.

The majorant mode is a different *sampling strategy* for the same estimand:
converged images agree in expectation but individual sample paths (and RNG
consumption) differ, so parity is asserted statistically against the exact
path's own seed-to-seed noise floor (self-calibrating — no magic tolerance).
"""

import numpy as np
import pytest

from vpt_tpu.models import mcm_spectral as M
from vpt_tpu.ops import interp
from vpt_tpu.ops.majorant import build_majorant_grid
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import (
    LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig,
)

EXT = 20.0


def _ramp_tf():
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    return table


def _renderer(majorant_blocks=None, seed_scene=None):
    return M.MCMSpectralRenderer(
        Volume.sphere_in_cube(32), MaterialTF(_ramp_tf()),
        LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
        MCMSpectralConfig(extinction=EXT, bounces=8, steps=8),
        resolution=48, majorant_blocks=majorant_blocks,
    )


@pytest.mark.parametrize("size,spike", [(32, None), (33, (26, 30, 14)),
                                        (37, (36, 0, 20))])
def test_majorant_bounds_alpha_within_range(size, spike):
    """For random points x and probes y with |y-x| <= range(cell(x)), the
    stored majorant must bound the actually-sampled TF alpha at y.

    Non-divisible sizes (33, 37 with block=4) pin the normalized-space cell
    windows: the old block-slab windows were misaligned with the kernel's
    floor(p*G) cells, and a density spike near the high end of an axis
    (z-voxel 26 of 33 was the reproducer) escaped its cell's window —
    the stored majorant read 0 while the spike was reachable within the
    flight cap, a silent delta-tracking bias."""
    vol = Volume.sphere_in_cube(size)
    density = np.asarray(vol.density)
    if spike is not None:  # adversarial spike at the given (z, y, x) voxel
        density = density.copy()
        density[spike] = 1.0
    tf = _ramp_tf()
    grid = build_majorant_grid(density, tf, EXT, block=4)
    G = grid.shape[0]

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, size=(4000, 3)).astype(np.float32)
    cell = np.clip(np.floor(x * G).astype(int), 0, G - 1)
    m = grid[cell[:, 2], cell[:, 1], cell[:, 0], 0]  # x=(u,v,w) -> (z,y,x)
    r = grid[cell[:, 2], cell[:, 1], cell[:, 0], 1]

    # random probe within the validity sphere (also inside the domain)
    d = rng.normal(size=(4000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    y = np.clip(x + d * (rng.uniform(0, 1, (4000, 1)) * r[:, None]), 0.0, 1.0)

    import jax.numpy as jnp

    dens = np.asarray(
        interp.sample_volume(
            jnp.asarray(density),
            jnp.asarray(y[:, 0]), jnp.asarray(y[:, 1]), jnp.asarray(y[:, 2]),
            "linear",
        )
    )
    t = rng.uniform(0, 1, 4000).astype(np.float32)
    alpha = np.asarray(
        interp.sample_tex2d(jnp.asarray(tf), jnp.asarray(t), jnp.asarray(dens))
    )[:, 1]
    assert np.all(m >= alpha - 1e-6), (
        f"majorant violated: worst slack {np.min(m - alpha)}"
    )

    if spike is not None:
        # deterministic reproducer of the pre-fix bias: every cell whose
        # validity sphere can reach the spike's voxel center must store a
        # majorant >= the alpha there (the spike density is 1.0 -> alpha 1.0)
        n = size
        ps = (np.array([spike[2], spike[1], spike[0]]) + 0.5) / n  # (u, v, w)
        cz, cy, cx = np.meshgrid(*[np.arange(G)] * 3, indexing="ij")
        lo = np.stack([cx, cy, cz], axis=-1) / G  # cell box in (u, v, w)
        hi = (np.stack([cx, cy, cz], axis=-1) + 1) / G
        nearest = np.clip(ps, lo, hi)
        dist = np.linalg.norm(nearest - ps, axis=-1)
        reach = dist < grid[..., 1] - 1e-6
        alpha_at_spike = tf[-1, :, 1].max()
        bad = reach & (grid[..., 0] < alpha_at_spike - 1e-5)
        assert not bad.any(), (
            f"{bad.sum()} cells can reach the spike within their flight cap "
            f"but store a majorant below its alpha"
        )


def test_majorant_grid_shapes_and_ranges():
    vol = Volume.sphere_in_cube(33)  # non-divisible size exercises padding
    grid = build_majorant_grid(vol.density, _ramp_tf(), EXT, block=4)
    assert grid.shape == (9, 9, 9, 2)
    assert np.isfinite(grid).all()
    assert (grid[..., 0] >= 0).all() and (grid[..., 0] <= 1 + 1e-3).all()
    assert (grid[..., 1] > 0).all()  # every cell guarantees some progress


def _converged(renderer, seed, dispatches=96):
    cam = Camera()
    state = renderer.reset(cam, seed)
    seeds = [(seed + k + 1) * 2654435761 % 2**32 for k in range(dispatches)]
    state, img = renderer.render_many(state, cam, seeds)
    return np.asarray(img), int(np.asarray(state.samples).sum())


def test_majorant_image_parity_and_progress():
    img_a, paths_a = _converged(_renderer(None), seed=1)
    img_b, _ = _converged(_renderer(None), seed=991)  # noise floor pair
    img_m, paths_m = _converged(_renderer(4), seed=1)

    floor = np.abs(img_a - img_b).mean()
    diff = np.abs(img_a - img_m).mean()
    assert diff < 2.0 * floor + 1e-4, (diff, floor)
    # mean brightness agrees to Monte-Carlo accuracy
    assert abs(img_a.mean() - img_m.mean()) < 0.1 * img_a.mean() + 1e-5

    # the mode must actually make paths finish in fewer steps
    assert paths_m > paths_a


def test_majorant_on_mesh_bit_identical():
    """Majorant mode composes with the rays mesh (replicated table)."""
    import jax
    import numpy as np

    from vpt_tpu.parallel.mesh import ray_mesh, replicated, shard_spectral_state

    renderer = _renderer(4)
    cam = Camera()
    ctx = renderer.ctx(cam, 3)
    state = renderer.reset(cam, 3)
    _, ref_img = M.render(state, ctx, steps=8, n_bins=12)

    mesh = ray_mesh(8)
    ctx2 = jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)),
                        renderer.ctx(cam, 3))
    state2 = shard_spectral_state(renderer.reset(cam, 3), mesh)
    _, out_img = M.render(state2, ctx2, steps=8, n_bins=12)
    np.testing.assert_array_equal(np.asarray(out_img), np.asarray(ref_img))


def test_majorant_with_slab_volume_bit_identical():
    """Majorant mode composes with the slab-sharded volume (the majorant
    table stays replicated; only the corner table shards)."""
    import jax
    import numpy as np

    from vpt_tpu.parallel import slab
    from vpt_tpu.parallel.mesh import ray_mesh, replicated, shard_spectral_state

    vol = Volume.sphere_in_cube(32)
    renderer = M.MCMSpectralRenderer(
        vol, MaterialTF(_ramp_tf()),
        LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
        MCMSpectralConfig(extinction=EXT, bounces=8, steps=6),
        resolution=16, majorant_blocks=8,
    )
    cam = Camera()
    ctx = renderer.ctx(cam, 5)
    state = renderer.reset(cam, 5)
    _, ref_img = M.render(state, ctx, steps=6, n_bins=12)

    mesh = ray_mesh(8)
    packed = slab.pad_packed_for_slabs(interp.pack_volume_corners(vol.density), 8)
    ctx2 = jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)),
                        renderer.ctx(cam, 5))
    ctx2 = ctx2._replace(density=slab.shard_packed_volume(packed, mesh))
    state2 = shard_spectral_state(renderer.reset(cam, 5), mesh)
    _, out_img = slab.render_slab(
        state2, ctx2, mesh, volume_dims=vol.density.shape, steps=6, n_bins=12
    )
    np.testing.assert_array_equal(np.asarray(out_img), np.asarray(ref_img))


def test_majorant_gradient_path_contract():
    """r5 contract: the autodiff surrogate SUPPORTS the
    majorant mode (score-form capped/uncapped flights + alpha/m wheel —
    FD-validated in tests/test_majorant_grad.py); the taped packed-PRB
    backward (collect=True) still raises."""
    import jax.numpy as jnp

    renderer = _renderer(4)
    cam = Camera()
    ctx = renderer.ctx(cam, 1)
    state = renderer.reset(cam, 1)
    score = jnp.ones_like(state.px)
    _, _, img = M.render_diff(state, score, ctx, steps=2, n_bins=12)
    assert np.isfinite(np.asarray(img)).all()

    from vpt_tpu.ops import geometry, sampling

    ix, iy, seed_iy = M._pixel_grid(state.px.shape[-1], 1)
    sx, sy = geometry.screen_position(ix, iy, 1.0 / state.px.shape[-1])
    rng = sampling.seed_state(ix, seed_iy, ctx.seed_bits)
    with pytest.raises(NotImplementedError):
        M._render_body(renderer.reset(cam, 1), rng, None, sx, sy, ctx, 12,
                       "linear", diff=False, collect=True)
