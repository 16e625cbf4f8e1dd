"""Deterministic ray-march renderer family: EAM, MIP, ISO, Depth.

JAX rebuilds of the reference's fragment-shader ray marchers (the
WebGL2 stack, plus the WGSL EAM):
  - EAM  : front-to-back emission-absorption compositing
           (/root/reference/src/glsl/renderers/EAMRenderer.glsl:49-76,
            src/wgsl/renderers/EAMRenderer.wgsl:55-85)
  - MIP  : maximum-intensity projection with offset-wrapped march
           (src/glsl/renderers/MIPRenderer.glsl:47-68)
  - ISO  : iso-surface closest-hit search + Lambert shading from a
           central-difference gradient (src/glsl/renderers/ISORenderer.glsl)
  - Depth: first crossing of an opacity-accumulation threshold
           (src/glsl/renderers/DepthRenderer.glsl:49-75)

Each renderer is a pair of jitted pure functions: ``frame`` (one stochastic-
offset march over all pixels — the fullscreen fragment pass) and ``merge``
(the reference's accumulation pass: running average / max / closest).
The marches are fixed-trip-count ``lax.scan``s with lane masking instead of
data-dependent while-loops, and are differentiable end-to-end (used by the
inverse-rendering path).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vpt_tpu.models.base import register_renderer
from vpt_tpu.ops import geometry, interp
from vpt_tpu.utils.config import EAMConfig


def _seed_to_offset(seed: int) -> float:
    """Deterministic per-frame march offset in [0,1) (the reference used
    Math.random(); a Weyl/Knuth multiplicative hash keeps replays exact)."""
    return (int(seed) * 2654435761 % 2**32) / 2**32


def camera_rays(resolution: int, inv_mvp):
    """Per-pixel unjittered rays: NDC near/far plane unprojection
    (src/wgsl/mixins/unproject.wgsl semantics)."""
    iy = jax.lax.broadcasted_iota(jnp.float32, (resolution, resolution), 0)
    ix = jax.lax.broadcasted_iota(jnp.float32, (resolution, resolution), 1)
    inv_res = 1.0 / resolution
    sx = ((ix + 0.5) * inv_res - 0.5) * 2.0
    sy = ((iy + 0.5) * inv_res - 0.5) * -2.0
    fx, fy, fz = geometry._apply_homogeneous(inv_mvp, sx, sy, -1.0)
    tx, ty, tz = geometry._apply_homogeneous(inv_mvp, sx, sy, 1.0)
    return (fx, fy, fz), (tx, ty, tz)


def ray_bounds(frm, to):
    """Clamp cube intersection; returns (tnear, tfar, miss)."""
    dx, dy, dz = to[0] - frm[0], to[1] - frm[1], to[2] - frm[2]
    tn, tf = geometry.intersect_cube(frm[0], frm[1], frm[2], dx, dy, dz)
    tn = jnp.maximum(tn, 0.0)
    tf = jnp.maximum(tf, 0.0)
    return tn, tf, tn >= tf


def _mix3(frm, to, t):
    return (
        frm[0] + (to[0] - frm[0]) * t,
        frm[1] + (to[1] - frm[1]) * t,
        frm[2] + (to[2] - frm[2]) * t,
    )


def sample_tf(density, tf_table, px, py, pz, volume_filter="linear"):
    """volume density -> classic 2D TF lookup at (density, 0) — the scalar
    volume's second channel reads 0 (r8 texture .g)."""
    d = interp.sample_volume(density, px, py, pz, volume_filter)
    return interp.sample_tex2d(tf_table, d, jnp.zeros_like(d))



def _pack_if_linear(volume, tf2d):
    """Device-resident (density, tf_table), corner-packed for linear filters
    (single-gather sampling; bit-identical results — see ops/interp).
    pack_volume_auto picks the representation (flat u8 for u8-quantized
    sources — the r4 layout-wall winner at every size)."""
    density = volume.density
    tf_table = tf2d.rasterize()
    if volume.filter in ("linear", "quasicubic"):
        density = interp.pack_volume_auto(density, "full")
        tf_table = interp.pack_tex2d_corners(tf_table)
    if not isinstance(density, interp.PackedVolume):
        density = jnp.asarray(density)
    return density, jnp.asarray(tf_table)


# ==========================================================================
# EAM
# ==========================================================================
@functools.partial(jax.jit, static_argnames=("slices", "resolution", "volume_filter"))
def eam_frame(inv_mvp, density, tf_table, extinction, offset, slices: int,
              resolution: int = 512, volume_filter: str = "linear"):
    """One front-to-back compositing pass; returns (H, W, 3) linear RGB."""
    res = resolution
    frm, to = camera_rays(res, inv_mvp)
    tn, tf_, miss = ray_bounds(frm, to)
    entry = _mix3(frm, to, tn)
    exit_ = _mix3(frm, to, tf_)

    step = 1.0 / slices
    seg = jnp.sqrt(
        (exit_[0] - entry[0]) ** 2 + (exit_[1] - entry[1]) ** 2 + (exit_[2] - entry[2]) ** 2
    )
    ray_step_len = seg * step

    def body(carry, k):
        acc_r, acc_g, acc_b, acc_a = carry
        t = step * offset + k * step
        active = (t < 1.0) & (acc_a < 0.99)
        pos = _mix3(entry, exit_, t)
        c = sample_tf(density, tf_table, *pos, volume_filter)
        a = c[..., 3] * ray_step_len * extinction
        w = jnp.where(active, (1.0 - acc_a) * a, 0.0)
        return (
            (acc_r + w * c[..., 0], acc_g + w * c[..., 1], acc_b + w * c[..., 2], acc_a + w),
            None,
        )

    z = jnp.zeros((res, res), jnp.float32)
    (r, g, b, a), _ = jax.lax.scan(body, (z, z, z, z), jnp.arange(slices + 1))
    # over-saturation renormalization (glsl:71-73); max() keeps the unselected
    # 1/a branch finite at a=0 so cotangents don't NaN through the where
    scale = jnp.where(a > 1.0, 1.0 / jnp.maximum(a, 1.0), 1.0)
    rgb = jnp.stack([r * scale, g * scale, b * scale], axis=-1)
    return jnp.where(miss[..., None], 0.0, rgb)


@register_renderer("eam")
class EAMRenderer:
    """Progressive EAM: stochastic offset per frame + running average
    (EAMRenderer.js:101-103 + the uMix average pass)."""

    def __init__(self, volume, tf2d=None, config: EAMConfig | None = None,
                 resolution: int = 512):
        from vpt_tpu.scene.tf import TransferFunction2D

        self.volume = volume
        self.tf2d = tf2d or TransferFunction2D.grayscale_ramp()
        self.config = config or EAMConfig()
        self.resolution = resolution
        self._density, self._tf_table = _pack_if_linear(volume, self.tf2d)

    def reset(self, camera, seed: int = 0):
        return dict(
            acc=jnp.zeros((self.resolution, self.resolution, 3), jnp.float32),
            frame=jnp.zeros((), jnp.int32),
        )

    def render(self, state, camera, seed: int):
        offset = _seed_to_offset(seed) if self.config.random_offset else 0.0
        img = eam_frame(
            jnp.asarray(camera.inverse_mvp()),
            self._density,
            self._tf_table,
            jnp.float32(self.config.extinction),
            jnp.float32(offset),
            slices=self.config.slices,
            resolution=self.resolution,
            volume_filter=self.volume.filter,
        )
        frame = state["frame"] + 1
        mix = 1.0 / frame.astype(jnp.float32)
        acc = state["acc"] + (img - state["acc"]) * mix
        return dict(acc=acc, frame=frame), acc


# ==========================================================================
# MIP
# ==========================================================================
@functools.partial(jax.jit, static_argnames=("steps", "resolution", "volume_filter"))
def mip_frame(inv_mvp, density, tf_table, offset, steps: int, resolution: int,
              volume_filter: str = "linear"):
    """One maximum-intensity pass over the offset-wrapped march
    (MIPRenderer.glsl:54-66); returns (H, W) scalar intensity."""
    frm, to = camera_rays(resolution, inv_mvp)
    tn, tf_, miss = ray_bounds(frm, to)
    entry = _mix3(frm, to, tn)
    exit_ = _mix3(frm, to, tf_)
    step = 1.0 / steps

    def body(val, k):
        o = jnp.mod(offset + k * step, 1.0)
        pos = _mix3(entry, exit_, o)
        c = sample_tf(density, tf_table, *pos, volume_filter)
        return jnp.maximum(val, c[..., 3]), None

    val, _ = jax.lax.scan(body, jnp.zeros((resolution, resolution), jnp.float32),
                          jnp.arange(steps))
    return jnp.where(miss, 0.0, val)


@register_renderer("mip")
class MIPRenderer:
    def __init__(self, volume, tf2d=None, steps: int = 64, resolution: int = 512):
        from vpt_tpu.scene.tf import TransferFunction2D

        self.volume = volume
        self.tf2d = tf2d or TransferFunction2D.grayscale_ramp()
        self.steps = steps
        self.resolution = resolution
        self._density, self._tf_table = _pack_if_linear(volume, self.tf2d)

    def reset(self, camera, seed: int = 0):
        return dict(acc=jnp.zeros((self.resolution, self.resolution), jnp.float32))

    def render(self, state, camera, seed: int):
        offset = _seed_to_offset(seed)
        val = mip_frame(
            jnp.asarray(camera.inverse_mvp()), self._density, self._tf_table,
            jnp.float32(offset), steps=self.steps, resolution=self.resolution,
            volume_filter=self.volume.filter,
        )
        acc = jnp.maximum(state["acc"], val)  # integrate = max (MIP merge pass)
        return dict(acc=acc), jnp.repeat(acc[..., None], 3, axis=-1)


# ==========================================================================
# ISO
# ==========================================================================
@functools.partial(jax.jit, static_argnames=("steps", "resolution", "volume_filter"))
def iso_frame(inv_mvp, density, tf_table, isovalue, offset, steps: int,
              resolution: int, volume_filter: str = "linear"):
    """Closest-hit search scanning far->near (ISORenderer.glsl:58-74);
    returns (px, py, pz, t) with t = -1 on miss."""
    frm, to = camera_rays(resolution, inv_mvp)
    tn, tf_, miss = ray_bounds(frm, to)
    entry = _mix3(frm, to, tn)
    exit_ = _mix3(frm, to, tf_)
    step = 1.0 / steps

    def body(carry, k):
        cx, cy, cz, ct = carry
        t = 1.0 - offset * step - k * step
        pos = _mix3(entry, exit_, t)
        c = sample_tf(density, tf_table, *pos, volume_filter)
        hit = (c[..., 3] >= isovalue) & (t >= 0.0)
        return (
            jnp.where(hit, pos[0], cx),
            jnp.where(hit, pos[1], cy),
            jnp.where(hit, pos[2], cz),
            jnp.where(hit, t, ct),
        ), None

    neg = jnp.full((resolution, resolution), -1.0, jnp.float32)
    (cx, cy, cz, ct), _ = jax.lax.scan(body, (neg, neg, neg, neg), jnp.arange(steps))
    ct = jnp.where(miss, -1.0, ct)
    return cx, cy, cz, ct


@functools.partial(jax.jit, static_argnames=("volume_filter",))
def iso_shade(closest, density, tf_table, light_model, gradient_step,
              volume_filter: str = "linear"):
    """Lambert shading at the merged closest hit (ISORenderer.glsl shade
    pass): central-difference gradient of the TF alpha, white on miss."""
    cx, cy, cz, ct = closest
    h = gradient_step

    def alpha_at(px, py, pz):
        return sample_tf(density, tf_table, px, py, pz, volume_filter)[..., 3]

    gx = alpha_at(cx + h, cy, cz) - alpha_at(cx - h, cy, cz)
    gy = alpha_at(cx, cy + h, cz) - alpha_at(cx, cy - h, cz)
    gz = alpha_at(cx, cy, cz + h) - alpha_at(cx, cy, cz - h)
    norm = jnp.sqrt(gx * gx + gy * gy + gz * gz)
    inv = 1.0 / jnp.maximum(norm, 1e-20)
    lambert = jnp.maximum(
        (gx * light_model[0] + gy * light_model[1] + gz * light_model[2]) * inv, 0.0
    )
    material = sample_tf(density, tf_table, cx, cy, cz, volume_filter)[..., :3]
    rgb = material * lambert[..., None]
    return jnp.where((ct > 0.0)[..., None], rgb, 1.0)


@register_renderer("iso")
class ISORenderer:
    def __init__(self, volume, tf2d=None, steps: int = 50, isovalue: float = 0.5,
                 light=(2.0, -3.0, -5.0), resolution: int = 512):
        from vpt_tpu.scene.tf import TransferFunction2D

        self.volume = volume
        self.tf2d = tf2d or TransferFunction2D.grayscale_ramp()
        self.steps = steps
        self.isovalue = isovalue
        self.light = np.asarray(light, np.float64)
        self.resolution = resolution
        self._density, self._tf_table = _pack_if_linear(volume, self.tf2d)

    def reset(self, camera, seed: int = 0):
        neg = jnp.full((self.resolution, self.resolution), -1.0, jnp.float32)
        return dict(cx=neg, cy=neg, cz=neg, ct=neg)

    def _light_model_space(self, camera):
        """View-space light through inv(V @ M) with w=1 then normalize —
        the reference's transformMat4 point-transform quirk
        (ISORenderer.js:156-162)."""
        from vpt_tpu.scene import transform as T

        m = camera.view_matrix @ T.translate([-0.5, -0.5, -0.5])
        inv = np.linalg.inv(m)
        v = inv @ np.array([*self.light, 1.0])
        v = v[:3] / v[3]
        return (v / np.linalg.norm(v)).astype(np.float32)

    def render(self, state, camera, seed: int):
        offset = _seed_to_offset(seed)
        cx, cy, cz, ct = iso_frame(
            jnp.asarray(camera.inverse_mvp()), self._density, self._tf_table,
            jnp.float32(self.isovalue), jnp.float32(offset),
            steps=self.steps, resolution=self.resolution,
            volume_filter=self.volume.filter,
        )
        # closest merge (ISORenderer.glsl merge pass): keep smaller positive t
        both = (ct > 0) & (state["ct"] > 0)
        take_new = (both & (ct < state["ct"])) | ((~both) & (ct > 0))
        merged = dict(
            cx=jnp.where(take_new, cx, state["cx"]),
            cy=jnp.where(take_new, cy, state["cy"]),
            cz=jnp.where(take_new, cz, state["cz"]),
            ct=jnp.where(take_new, ct, state["ct"]),
        )
        img = iso_shade(
            (merged["cx"], merged["cy"], merged["cz"], merged["ct"]),
            self._density, self._tf_table,
            jnp.asarray(self._light_model_space(camera)),
            jnp.float32(0.005),
            volume_filter=self.volume.filter,
        )
        return merged, img


# ==========================================================================
# Depth
# ==========================================================================
@functools.partial(jax.jit, static_argnames=("slices", "resolution", "volume_filter"))
def depth_frame(inv_mvp, density, tf_table, extinction, threshold, offset,
                slices: int, resolution: int, volume_filter: str = "linear"):
    """March until accumulated opacity crosses ``threshold``; returns t of the
    crossing in [tnear, tfar] or -1 (DepthRenderer.glsl:49-75)."""
    frm, to = camera_rays(resolution, inv_mvp)
    tn, tf_, miss = ray_bounds(frm, to)
    entry = _mix3(frm, to, tn)
    exit_ = _mix3(frm, to, tf_)
    step = 1.0 / slices
    seg = jnp.sqrt(
        (exit_[0] - entry[0]) ** 2 + (exit_[1] - entry[1]) ** 2 + (exit_[2] - entry[2]) ** 2
    )
    ray_step_len = seg * step

    def body(carry, k):
        acc, t_stop = carry
        t = step * offset + k * step
        active = (t < 1.0) & (acc < threshold)
        pos = _mix3(entry, exit_, t)
        c = sample_tf(density, tf_table, *pos, volume_filter)
        acc2 = acc + jnp.where(active, (1.0 - acc) * c[..., 3] * ray_step_len * extinction, 0.0)
        # record the t at which the march stopped (first crossing)
        crossed = active & (acc2 >= threshold)
        t_stop = jnp.where(crossed, t + step, t_stop)
        return (acc2, t_stop), None

    z = jnp.zeros((resolution, resolution), jnp.float32)
    (acc, t_stop), _ = jax.lax.scan(body, (z, jnp.full_like(z, -1.0)), jnp.arange(slices + 1))
    depth = jnp.where(acc >= threshold, tn + (tf_ - tn) * t_stop, -1.0)
    return jnp.where(miss, -1.0, depth)


@register_renderer("depth")
class DepthRenderer:
    def __init__(self, volume, tf2d=None, extinction: float = 100.0,
                 slices: int = 64, threshold: float = 0.1,
                 random_offset: bool = False, resolution: int = 512):
        from vpt_tpu.scene.tf import TransferFunction2D

        self.volume = volume
        self.tf2d = tf2d or TransferFunction2D.grayscale_ramp()
        self.extinction = extinction
        self.slices = slices
        self.threshold = threshold
        self.random_offset = random_offset
        self.resolution = resolution
        self._density, self._tf_table = _pack_if_linear(volume, self.tf2d)

    def reset(self, camera, seed: int = 0):
        return dict(frame=jnp.zeros((), jnp.int32))

    def render(self, state, camera, seed: int):
        offset = _seed_to_offset(seed) if self.random_offset else 0.0
        depth = depth_frame(
            jnp.asarray(camera.inverse_mvp()), self._density, self._tf_table,
            jnp.float32(self.extinction), jnp.float32(self.threshold),
            jnp.float32(offset), slices=self.slices, resolution=self.resolution,
            volume_filter=self.volume.filter,
        )
        # display: normalized depth as grayscale, misses white
        vis = jnp.where(depth < 0, 1.0, jnp.clip(depth, 0.0, 1.0))
        return state, jnp.repeat(vis[..., None], 3, axis=-1)
