"""Local ambient occlusion + soft shadows renderer (LAO).

JAX rebuild of the reference's src/glsl/renderers/LAORenderer.glsl:
an emission-absorption march where every step darkens the TF color by
(a) a light-cone ambient-occlusion integral (glsl LAO loop: density samples
along the jittered half-vector weighted (1-t)^2) and (b) a soft-shadow term
(sphere samples around the light radius), both tinted with the shader's
fixed blue-gray constants.

Faithfully preserved quirks of this research shader:
  - `rand(p)` is a pure hash of the pixel's NDC position, so every "random"
    draw inside a pixel's loops returns the same value (the directions are
    per-pixel constants);
  - the light is transformed by inv(MVP) *without* the perspective divide
    (vLight = (inv_mvp @ [light, 1]).xyz, vertex shader :25);
  - gradient voxel size is hardcoded to 1/32 (glsl `voxelSize`);
  - the march stops once accumulated alpha exceeds 0.9 (the three nested
    thresholds 0.99/0.98/0.9 reduce to this);
  - the merge pass shows the latest frame only (no temporal accumulation).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from vpt_tpu.models.base import register_renderer
from vpt_tpu.ops import interp
from vpt_tpu.models.raymarch import camera_rays, ray_bounds, _mix3


def rand2(px, py):
    """The reference's `rand` mixin (glsl/mixins/rand.glsl): a trig hash of a
    2-vector -> 2 uniforms."""
    dx = 23.14069263277926 * px + 2.665144142690225 * py
    dy = 12.98987893203892 * px + 78.23376739376591 * py
    mx = jnp.cos(dx) * 1235.6789
    my = jnp.sin(dy) * 4378.5453
    return mx - jnp.floor(mx), my - jnp.floor(my)


@functools.partial(
    jax.jit,
    static_argnames=("lao_step", "slices", "resolution", "num_lao_samples",
                     "num_shadow_samples", "lao_enabled", "shadows_enabled",
                     "volume_filter"),
)
def lao_frame(inv_mvp, density, tf_table, light_position, extinction,
              lao_weight, shadows_weight, light_radius, light_coef, *,
              lao_step: float, slices: int, resolution: int, num_lao_samples: int = 1,
              num_shadow_samples: int = 10, lao_enabled: bool = True,
              shadows_enabled: bool = True, volume_filter: str = "linear"):
    frm, to = camera_rays(resolution, inv_mvp)
    tn, tf_, miss = ray_bounds(frm, to)
    entry = _mix3(frm, to, tn)
    exit_ = _mix3(frm, to, tf_)
    step = 1.0 / slices

    # vLight = (inv_mvp @ [light, 1]).xyz without the w divide
    lv = jnp.matmul(
        inv_mvp, jnp.concatenate([light_position, jnp.ones(1, jnp.float32)]),
        precision=jax.lax.Precision.HIGHEST)
    lx, ly, lz = lv[0], lv[1], lv[2]

    # per-pixel NDC and its constant "random" pair
    iy = jax.lax.broadcasted_iota(jnp.float32, (resolution, resolution), 0)
    ix = jax.lax.broadcasted_iota(jnp.float32, (resolution, resolution), 1)
    ndc_x = ((ix + 0.5) / resolution - 0.5) * 2.0
    ndc_y = ((iy + 0.5) / resolution - 0.5) * -2.0
    rx, _ry = rand2(ndc_x * 3.14, ndc_y * 2.71)
    g_rx, _ = rand2(jnp.full_like(ndc_x, 3.14), jnp.full_like(ndc_y, 2.71))

    h = 1.0 / 32.0  # the reference's hardcoded gradient voxel size

    def vol(px, py, pz):
        return interp.sample_volume(density, px, py, pz, volume_filter)

    t0 = jnp.clip(rx * step * 1.5, 0.0, 1.0)

    # per-pixel constant LAO jitter direction: (-1+2r, -1+2r, -1+2r)/|.| * r
    lao_d = (2.0 * rx - 1.0) / jnp.sqrt(3.0 * (2.0 * rx - 1.0) ** 2 + 1e-20)
    lao_dx = lao_d * rx
    # per-pixel constant shadow direction
    sdx = -1.0 + lx * rx
    sdy = ly + rx * lz
    sdz = -1.0 + 2.0 * g_rx
    sn = jnp.sqrt(sdx * sdx + sdy * sdy + sdz * sdz)
    sdx, sdy, sdz = sdx / sn * rx, sdy / sn * rx, sdz / sn * rx
    s_len = rx  # |normalized * rx| = rx

    n_lao_t = int(np.ceil((1.0 - 0.001) / float(lao_step)))

    def body(carry, k):
        acc_r, acc_g, acc_b, acc_a = carry
        t = t0 + k * step
        active = (t < 1.0) & (acc_a <= 0.9)
        pos = _mix3(entry, exit_, t)

        gx = vol(pos[0] - h, pos[1], pos[2]) - vol(pos[0] + h, pos[1], pos[2])
        gy = vol(pos[0], pos[1] - h, pos[2]) - vol(pos[0], pos[1] + h, pos[2])
        gz = vol(pos[0], pos[1], pos[2] - h) - vol(pos[0], pos[1], pos[2] + h)
        gmag = jnp.sqrt(gx * gx + gy * gy + gz * gz)
        inv_g = 1.0 / jnp.maximum(gmag, 1e-20)
        value = vol(*pos)

        hx, hy, hz = lx - pos[0], ly - pos[1], lz - pos[2]
        hn = jnp.sqrt(hx * hx + hy * hy + hz * hz)
        hx, hy, hz = hx / hn, hy / hn, hz / hn

        lao = jnp.zeros_like(value)
        if lao_enabled:
            acc_lao = jnp.zeros_like(value)
            for i in range(n_lao_t):
                tt = 0.001 + i * float(lao_step)
                jx = lx + lao_dx * (light_radius * tt) - pos[0]
                jy = ly + lao_dx * (light_radius * tt) - pos[1]
                jz = lz + lao_dx * (light_radius * tt) - pos[2]
                jn = jnp.sqrt(jx * jx + jy * jy + jz * jz)
                sp = (pos[0] + jx / jn * tt, pos[1] + jy / jn * tt, pos[2] + jz / jn * tt)
                acc_lao = acc_lao + vol(*sp) * (1.0 - tt) ** 2
            acc_lao = jnp.clip(acc_lao / light_coef, 0.0, 1.0)
            # num_lao_samples identical contributions average to one
            lao = acc_lao

        shadow = jnp.zeros_like(value)
        if shadows_enabled:
            s = vol(pos[0] + sdx * light_radius, pos[1] + sdy * light_radius,
                    pos[2] + sdz * light_radius)
            contrib = s * (s * 0.2) * s_len
            # num_shadow_samples identical samples: mean = contrib
            shadow = jnp.clip(contrib * 20.0, 0.0, 1.0)
            shadow = jnp.clip((1.0 * (1.0 - 1.2) + shadow * 1.2) / 1.3, 0.0, 1.0)

        tf4 = interp.sample_tex2d(tf_table, value, gmag)
        cr, cg, cb = tf4[..., 0], tf4[..., 1], tf4[..., 2]
        # tint mixes (glsl :176-177)
        wl = lao * lao_weight
        cr = cr + (cr * 0.15 - cr) * wl
        cg = cg + (cg * 0.18 - cg) * wl
        cb = cb + (cb * 0.32 - cb) * wl
        ws = shadow * shadows_weight
        cr = cr + (cr * 0.15 - cr) * ws
        cg = cg + (cg * 0.18 - cg) * ws
        cb = cb + (cb * 0.22 - cb) * ws

        w = jnp.where(active, (1.0 - acc_a) * value, 0.0)
        acc_r = acc_r + w * cr
        acc_g = acc_g + w * cg
        acc_b = acc_b + w * cb
        acc_a = acc_a + jnp.where(active, (1.0 - acc_a) * value * extinction / 100.0, 0.0)
        return (acc_r, acc_g, acc_b, acc_a), None

    z = jnp.zeros((resolution, resolution), jnp.float32)
    (r, g, b, a), _ = jax.lax.scan(body, (z, z, z, z), jnp.arange(slices + 1))
    scale = jnp.where(a > 1.0, 1.0 / a, 1.0)
    rgb = jnp.stack([r * scale, g * scale, b * scale], axis=-1)
    return jnp.where(miss[..., None], 0.0, rgb)


@register_renderer("lao")
class LAORenderer:
    def __init__(self, volume, tf2d=None, extinction: float = 100.0,
                 lao_enabled: bool = True, lao_weight: float = 0.69,
                 num_lao_samples: int = 1, lao_step: float = 0.05,
                 shadows_enabled: bool = True, shadows_weight: float = 0.54,
                 num_shadow_samples: int = 10, light_radius: float = 0.19,
                 light_position=(2.0, -3.0, -5.0), light_coef: float = 1.0,
                 slices: int = 64, resolution: int = 512):
        from vpt_tpu.scene.tf import TransferFunction2D

        self.volume = volume
        self.tf2d = tf2d or TransferFunction2D.grayscale_ramp()
        self.params = dict(
            extinction=extinction, lao_weight=lao_weight, lao_step=lao_step,
            shadows_weight=shadows_weight, light_radius=light_radius,
            light_coef=light_coef,
        )
        self.flags = dict(
            lao_enabled=lao_enabled, shadows_enabled=shadows_enabled,
            num_lao_samples=num_lao_samples, num_shadow_samples=num_shadow_samples,
        )
        self.light_position = np.asarray(light_position, np.float32)
        self.slices = slices
        self.resolution = resolution
        density = volume.density
        tf_table = self.tf2d.rasterize()
        if volume.filter in ("linear", "quasicubic"):
            density = interp.pack_volume_corners(density)
            tf_table = interp.pack_tex2d_corners(tf_table)
        self._density = jnp.asarray(density)
        self._tf_table = jnp.asarray(tf_table)

    def reset(self, camera, seed: int = 0):
        return dict(frame=jnp.zeros((), jnp.int32))

    def render(self, state, camera, seed: int):
        p = self.params
        img = lao_frame(
            jnp.asarray(camera.inverse_mvp()), self._density, self._tf_table,
            jnp.asarray(self.light_position), jnp.float32(p["extinction"]),
            jnp.float32(p["lao_weight"]),
            jnp.float32(p["shadows_weight"]), jnp.float32(p["light_radius"]),
            jnp.float32(p["light_coef"]),
            lao_step=p["lao_step"], slices=self.slices, resolution=self.resolution,
            num_lao_samples=self.flags["num_lao_samples"],
            num_shadow_samples=self.flags["num_shadow_samples"],
            lao_enabled=self.flags["lao_enabled"],
            shadows_enabled=self.flags["shadows_enabled"],
            volume_filter=self.volume.filter,
        )
        return dict(frame=state["frame"] + 1), img
