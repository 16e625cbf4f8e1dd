"""Directional occlusion shading (DOS) renderer.

JAX rebuild of the reference's src/glsl/renderers/DOSRenderer.glsl +
DOSRenderer.js: a front-to-back *slice sweep* through view-space depth where
each slice composites emission-absorption color modulated by an occlusion
buffer, and the occlusion buffer is advanced by cone-sampling itself at
disk-offset positions scaled by the slice distance and aperture
(glsl:54-62, 64-80; depth schedule DOSRenderer.js:139-160, 219-248).

State: (color RGBA, occlusion R) accumulation images + the sweep position.
Each ``render`` call advances ``steps`` slices (the reference's
per-frame chunking); the sweep ends at the cube's max view depth.
Display: mix(white, color.rgb, color.a) (the render pass).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vpt_tpu.models.base import register_renderer
from vpt_tpu.ops import interp
from vpt_tpu.scene import transform as T


def generate_occlusion_samples(n: int, seed: int = 0) -> np.ndarray:
    """Mean-centered disk samples (DOSRenderer.js:105-123), deterministic."""
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n))
    phi = rng.uniform(size=n) * 2 * np.pi
    pts = np.stack([r * np.cos(phi), r * np.sin(phi)], axis=-1)
    return (pts - pts.mean(axis=0, keepdims=True)).astype(np.float32)


def depth_range(camera) -> tuple:
    """Min/max view-space depth of the unit-cube corners
    (DOSRenderer.js:139-160)."""
    m = camera.view_matrix @ T.translate([-0.5, -0.5, -0.5])
    corners = np.array(
        [[x, y, z, 1.0] for x in (0, 1) for y in (0, 1) for z in (0, 1)]
    )
    depths = -(corners @ m.T)[:, 2]
    return max(float(depths.min()), 0.0), float(depths.max())


@functools.partial(jax.jit, static_argnames=("samples_count", "volume_filter"))
def dos_slice(color, occlusion, inv_mvp, density, tf_table, occl_samples,
              depth_ndc, occl_scale, slice_distance, extinction,
              samples_count: int, volume_filter: str = "linear"):
    """Integrate one slice (the glsl main at :64-80)."""
    H, W = occlusion.shape
    iy = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    ix = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    # fullscreen-triangle interpolation: uv in [0,1], NDC in [-1,1]
    u2 = (ix + 0.5) / W
    v2 = (iy + 0.5) / H
    ndc_x = u2 * 2.0 - 1.0
    ndc_y = v2 * 2.0 - 1.0

    from vpt_tpu.ops.geometry import _apply_homogeneous

    px, py, pz = _apply_homogeneous(inv_mvp, ndc_x, ndc_y, depth_ndc)

    oob = (px > 1.0) | (px < 0.0) | (py > 1.0) | (py < 0.0) | (pz > 1.0) | (pz < 0.0)

    d = interp.sample_volume(density, px, py, pz, volume_filter)
    tf4 = interp.sample_tex2d(tf_table, d, jnp.zeros_like(d))
    local_ext = tf4[..., 3] * extinction
    alpha = 1.0 - jnp.exp(-local_ext * slice_distance)

    prev_a = color[..., 3]
    contrib = tf4[..., :3] * occlusion[..., None] * alpha[..., None]
    new_rgb = color[..., :3] + contrib * (1.0 - prev_a)[..., None]
    new_a = jnp.minimum(prev_a + alpha, 1.0)
    new_color = jnp.concatenate([new_rgb, new_a[..., None]], axis=-1)

    # occlusion advance: mean of bilinear self-samples at disk offsets
    occ = jnp.zeros((H, W), jnp.float32)
    for i in range(samples_count):
        su = u2 + occl_samples[i, 0] * occl_scale[0]
        sv = v2 + occl_samples[i, 1] * occl_scale[1]
        occ = occ + interp.sample_tex2d(occlusion[..., None], su, sv)[..., 0]
    new_occl = (occ / samples_count) * jnp.exp(-local_ext * slice_distance)

    color = jnp.where(oob[..., None], color, new_color)
    occlusion = jnp.where(oob, occlusion, new_occl)
    return color, occlusion


@register_renderer("dos")
class DOSRenderer:
    def __init__(self, volume, tf2d=None, steps: int = 50, slices: int = 200,
                 extinction: float = 100.0, aperture: float = 30.0,
                 samples: int = 8, resolution: int = 512, sample_seed: int = 0):
        from vpt_tpu.scene.tf import TransferFunction2D

        self.volume = volume
        self.tf2d = tf2d or TransferFunction2D.grayscale_ramp()
        self.steps = steps
        self.slices = slices
        self.extinction = extinction
        self.aperture = aperture
        self.samples = samples
        self.resolution = resolution
        density = volume.density
        tf_table = self.tf2d.rasterize()
        if volume.filter in ("linear", "quasicubic"):
            density = interp.pack_volume_corners(density)
            tf_table = interp.pack_tex2d_corners(tf_table)
        self._density = jnp.asarray(density)
        self._tf_table = jnp.asarray(tf_table)
        self._occl_samples = jnp.asarray(generate_occlusion_samples(samples, sample_seed))

    def reset(self, camera, seed: int = 0):
        lo, hi = depth_range(camera)
        res = self.resolution
        return dict(
            color=jnp.zeros((res, res, 4), jnp.float32),
            occlusion=jnp.ones((res, res), jnp.float32),
            depth=lo,
            min_depth=lo,
            max_depth=hi,
        )

    def render(self, state, camera, seed: int):
        inv_mvp = jnp.asarray(camera.inverse_mvp())
        proj = camera.projection_matrix
        slice_distance = (state["max_depth"] - state["min_depth"]) / self.slices
        color, occlusion, depth = state["color"], state["occlusion"], state["depth"]
        occl_extent = slice_distance * np.tan(np.deg2rad(self.aperture))

        for _ in range(self.steps):
            if depth > state["max_depth"]:
                break
            # correction = P @ [1, 1, -depth, 1] with perspective divide
            # (DOSRenderer.js:233-239)
            c = proj @ np.array([1.0, 1.0, -depth, 1.0])
            c = c / c[3]
            occl_scale = (c[0] * occl_extent, c[1] * occl_extent)
            depth_ndc = float(c[2])
            color, occlusion = dos_slice(
                color, occlusion, inv_mvp, self._density, self._tf_table,
                self._occl_samples, jnp.float32(depth_ndc),
                (jnp.float32(occl_scale[0]), jnp.float32(occl_scale[1])),
                jnp.float32(slice_distance), jnp.float32(self.extinction),
                samples_count=self.samples, volume_filter=self.volume.filter,
            )
            depth += slice_distance

        new_state = dict(state, color=color, occlusion=occlusion, depth=depth)
        # display: blend over white by accumulated alpha (the render pass)
        img = (
            jnp.ones_like(color[..., :3]) * (1.0 - color[..., 3:4])
            + color[..., :3] * color[..., 3:4]
        )
        return new_state, img
