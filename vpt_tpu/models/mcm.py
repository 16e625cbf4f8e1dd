"""RGB multiple-scattering delta-tracking path tracer (MCMCompute).

JAX rebuild of the reference's src/wgsl/renderers/MCMComputeRenderer.wgsl
(:92-148 render loop, :150-210 reset) and its host
WebGPUMCMComputeRenderer.js. Same lane-masked vectorization strategy as the
spectral renderer (models/mcm_spectral.py); differences:

  - Photon state carries RGB transmittance + radiance (vec3) instead of
    spectral bins; no wavelength/bin.
  - Material lookup: 2D TF at (density, second-channel=0); rgb = color,
    a = true-extinction ratio; P_scatter = a * max(rgb).
  - Scatter multiplies transmittance by the TF rgb and samples HG with the
    *global* anisotropy uniform (not per-position).
  - Escape radiance = transmittance * equirect environment map sample.
  - Respawn draws: disk(2) + square(2) — no wavelength draw.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vpt_tpu.models.base import register_renderer
from vpt_tpu.ops import geometry, interp, sampling
from vpt_tpu.utils.config import MCMConfig

EPS = 1e-5
INVPI = 0.31830988618


class PhotonState(NamedTuple):
    px: jax.Array
    py: jax.Array
    pz: jax.Array
    dx: jax.Array
    dy: jax.Array
    dz: jax.Array
    bounces: jax.Array  # i32
    samples: jax.Array  # i32
    tr: jax.Array  # (H, W) transmittance r
    tg: jax.Array
    tb: jax.Array
    rr: jax.Array  # (H, W) radiance r
    rg: jax.Array
    rb: jax.Array


class MCMCtx(NamedTuple):
    inv_mvp: jax.Array
    seed_bits: jax.Array
    extinction: jax.Array
    blur: jax.Array
    anisotropy: jax.Array
    max_bounces: jax.Array
    density: jax.Array  # (D, H, W)
    tf_table: jax.Array  # (256, 256, 4)
    environment: jax.Array  # (He, We, 3) equirect radiance map


def sample_environment(env, dx, dy, dz):
    """Equirect lookup: texCoord = (atan2(x, -z), asin(-y)*2) * INVPI/2 + 0.5
    (MCMComputeRenderer.wgsl:55-58, y-quirk preserved)."""
    u = jnp.arctan2(dx, -dz) * (INVPI * 0.5) + 0.5
    v = jnp.arcsin(jnp.clip(-dy, -1.0, 1.0)) * 2.0 * (INVPI * 0.5) + 0.5
    return interp.sample_tex2d(env, u, v)


def _pixel_grid(resolution):
    iy = jax.lax.broadcasted_iota(jnp.uint32, (resolution, resolution), 0)
    ix = jax.lax.broadcasted_iota(jnp.uint32, (resolution, resolution), 1)
    return ix, iy


def _respawn(rng, mask, sx, sy, ctx: MCMCtx):
    """resetPhoton (wgsl:44-54): new camera ray, transmittance = 1."""
    inv_res = 1.0 / jnp.float32(sx.shape[-1])
    rng, (fx, fy, fz), (tx, ty, tz) = geometry.unproject_rand(
        rng, mask, sx, sy, ctx.inv_mvp, inv_res, ctx.blur
    )
    ndx, ndy, ndz = geometry.normalize3(tx - fx, ty - fy, tz - fz)
    tnear, _ = geometry.intersect_cube(fx, fy, fz, ndx, ndy, ndz)
    tnear = jnp.maximum(tnear, 0.0)
    return rng, dict(
        px=fx + tnear * ndx, py=fy + tnear * ndy, pz=fz + tnear * ndz,
        dx=ndx, dy=ndy, dz=ndz,
    )


@functools.partial(jax.jit, static_argnames=("resolution",))
def full_reset(ctx: MCMCtx, resolution: int) -> PhotonState:
    """Reset dispatch (wgsl:150-210): radiance initialized to 1."""
    ix, iy = _pixel_grid(resolution)
    sx, sy = geometry.screen_position(ix, iy, 1.0 / resolution)
    rng = sampling.seed_state(ix, iy, ctx.seed_bits)
    mask = jnp.ones((resolution, resolution), bool)
    rng, new = _respawn(rng, mask, sx, sy, ctx)
    one = jnp.ones((resolution, resolution), jnp.float32)
    zero_i = jnp.zeros((resolution, resolution), jnp.int32)
    return PhotonState(
        px=new["px"], py=new["py"], pz=new["pz"],
        dx=new["dx"], dy=new["dy"], dz=new["dz"],
        bounces=zero_i, samples=zero_i,
        tr=one, tg=one, tb=one, rr=one, rg=one, rb=one,
    )


def _render_body(p: PhotonState, rng, sx, sy, ctx: MCMCtx, volume_filter):
    all_mask = jnp.ones(p.px.shape, bool)

    rng, dist = sampling.draw_exponential(rng, all_mask, ctx.extinction)
    px = p.px + dist * p.dx
    py = p.py + dist * p.dy
    pz = p.pz + dist * p.dz

    d = interp.sample_volume(ctx.density, px, py, pz, volume_filter)
    tf4 = interp.sample_tex2d(ctx.tf_table, d, jnp.zeros_like(d))
    cr, cg, cb, alpha = tf4[..., 0], tf4[..., 1], tf4[..., 2], tf4[..., 3]

    p_null = 1.0 - alpha
    max3 = jnp.maximum(cr, jnp.maximum(cg, cb))
    p_scatter = jnp.where(p.bounces >= ctx.max_bounces, 0.0, alpha * max3)
    p_absorb = 1.0 - p_null - p_scatter

    rng, wheel = sampling.draw(rng, all_mask)

    oob = (px > 1.0) | (px < 0.0) | (py > 1.0) | (py < 0.0) | (pz > 1.0) | (pz < 0.0)
    absorb = (~oob) & (wheel < p_absorb)
    scatter = (~oob) & (~absorb) & (wheel < p_absorb + p_scatter)
    respawn = oob | absorb

    env = sample_environment(ctx.environment, p.dx, p.dy, p.dz)
    er = jnp.where(oob, p.tr * env[..., 0], 0.0)
    eg = jnp.where(oob, p.tg * env[..., 1], 0.0)
    eb = jnp.where(oob, p.tb * env[..., 2], 0.0)

    samples = p.samples + respawn.astype(jnp.int32)
    denom = jnp.maximum(samples, 1).astype(jnp.float32)
    rr = jnp.where(respawn, p.rr + (er - p.rr) / denom, p.rr)
    rg = jnp.where(respawn, p.rg + (eg - p.rg) / denom, p.rg)
    rb = jnp.where(respawn, p.rb + (eb - p.rb) / denom, p.rb)

    rng, new = _respawn(rng, respawn, sx, sy, ctx)

    rng, (hx, hy, hz) = sampling.draw_hg(
        rng, scatter, jnp.broadcast_to(ctx.anisotropy, p.dx.shape), p.dx, p.dy, p.dz
    )

    return (
        PhotonState(
            px=jnp.where(respawn, new["px"], px),
            py=jnp.where(respawn, new["py"], py),
            pz=jnp.where(respawn, new["pz"], pz),
            dx=jnp.where(respawn, new["dx"], jnp.where(scatter, hx, p.dx)),
            dy=jnp.where(respawn, new["dy"], jnp.where(scatter, hy, p.dy)),
            dz=jnp.where(respawn, new["dz"], jnp.where(scatter, hz, p.dz)),
            bounces=jnp.where(respawn, 0, p.bounces + scatter.astype(jnp.int32)),
            samples=samples,
            tr=jnp.where(respawn, 1.0, jnp.where(scatter, p.tr * cr, p.tr)),
            tg=jnp.where(respawn, 1.0, jnp.where(scatter, p.tg * cg, p.tg)),
            tb=jnp.where(respawn, 1.0, jnp.where(scatter, p.tb * cb, p.tb)),
            rr=rr, rg=rg, rb=rb,
        ),
        rng,
    )


@functools.partial(jax.jit, static_argnames=("steps", "volume_filter"),
                   donate_argnames=("state",))
def render(state: PhotonState, ctx: MCMCtx, steps: int, volume_filter: str = "linear"):
    resolution = state.px.shape[-1]
    ix, iy = _pixel_grid(resolution)
    sx, sy = geometry.screen_position(ix, iy, 1.0 / resolution)
    rng = sampling.seed_state(ix, iy, ctx.seed_bits)

    def body(_, carry):
        p, r = carry
        return _render_body(p, r, sx, sy, ctx, volume_filter)

    state, rng = jax.lax.fori_loop(0, steps, body, (state, rng))
    image = jnp.stack([state.rr, state.rg, state.rb], axis=-1)
    return state, image


@functools.partial(jax.jit, static_argnames=("steps", "volume_filter"),
                   donate_argnames=("state",))
def render_many(state: PhotonState, ctx: MCMCtx, seeds, steps: int,
                volume_filter: str = "linear"):
    """K render dispatches in one device program (lax.scan over frame
    seeds) — bit-identical to K sequential ``render`` calls, amortizing all
    host/dispatch overhead (same pattern as mcm_spectral.render_many)."""
    resolution = state.px.shape[-1]
    ix, iy = _pixel_grid(resolution)
    sx, sy = geometry.screen_position(ix, iy, 1.0 / resolution)

    def dispatch(p, seed_bits):
        c = ctx._replace(seed_bits=seed_bits)
        rng = sampling.seed_state(ix, iy, seed_bits)

        def body(_, carry):
            q, r = carry
            return _render_body(q, r, sx, sy, c, volume_filter)

        p, _ = jax.lax.fori_loop(0, steps, body, (p, rng))
        return p, None

    state, _ = jax.lax.scan(dispatch, state, seeds)
    image = jnp.stack([state.rr, state.rg, state.rb], axis=-1)
    return state, image


@register_renderer("mcm")
class MCMRenderer:
    """Progressive RGB MCM renderer bound to scene resources."""

    def __init__(self, volume, tf2d=None, environment=None,
                 config: MCMConfig | None = None, resolution: int = 512,
                 pack_tables: bool = True, compaction: bool = False):
        from vpt_tpu.scene.tf import TransferFunction2D

        self.volume = volume
        self.tf2d = tf2d or TransferFunction2D.grayscale_ramp()
        self.config = config or MCMConfig()
        self.resolution = resolution
        if environment is None:
            environment = np.ones((1, 1, 3), np.float32)  # white fallback env
        # hit-lane compaction (models/mcm_compact.py): march lanes only for
        # pixels whose ray bundle can hit the cube; miss pixels take the
        # closed-form E_jitter[env(dir)] (transmittance stays 1 on miss
        # rays, so the converged value is the subpixel-averaged env lookup)
        self.compaction = compaction
        if compaction:
            if self.config.blur != 0.0:
                raise ValueError("compaction requires blur=0")
            self._env_raw = np.asarray(environment, np.float32)
            self._compact_cache = {}
        density = volume.density
        tf_table = self.tf2d.rasterize()
        if pack_tables and volume.filter in ("linear", "quasicubic"):
            density = interp.pack_volume_auto(density, "full")
            tf_table = interp.pack_tex2d_corners(tf_table)
        cfg = self.config
        self._static_ctx = dict(
            extinction=jnp.float32(cfg.extinction),
            blur=jnp.float32(cfg.blur),
            anisotropy=jnp.float32(cfg.anisotropy),
            max_bounces=jnp.int32(cfg.bounces),
            density=(density if isinstance(density, interp.PackedVolume)
                     else jnp.asarray(density)),
            tf_table=jnp.asarray(tf_table),
            environment=jnp.asarray(environment, jnp.float32),
        )

    def ctx(self, camera, seed: int) -> MCMCtx:
        seed_bits = np.uint32(seed) if isinstance(seed, (int, np.integer)) else np.float32(seed).view(np.uint32)
        return MCMCtx(
            inv_mvp=jnp.asarray(camera.inverse_mvp()),
            seed_bits=jnp.uint32(seed_bits),
            **self._static_ctx,
        )

    # bounded per-pose cache, like MCMSpectralRenderer
    COMPACT_CACHE_POSES = 8

    def _compact_tables(self, camera):
        """Per-pose lane tables + closed-form miss image (bounded LRU).
        Shares the spectral compaction's host machinery — the hit test and
        lane packing are renderer-agnostic geometry."""
        from vpt_tpu.models import mcm_spectral_compact as C

        inv_mvp = camera.inverse_mvp()
        key = inv_mvp.tobytes()
        if key not in self._compact_cache:
            hit = C.hit_pixel_mask(inv_mvp, self.resolution)
            t = C.build_lane_tables(hit, self.resolution, streams=1)
            miss = C.mean_env_image(inv_mvp, self.resolution, self._env_raw)
            while len(self._compact_cache) >= self.COMPACT_CACHE_POSES:
                self._compact_cache.pop(next(iter(self._compact_cache)))
            self._compact_cache[key] = dict(
                hit=jnp.asarray(hit),
                miss=jnp.asarray(miss, jnp.float32),
                lane_ix=jnp.asarray(t["lane_ix"]),
                lane_iy=jnp.asarray(t["lane_iy"]),
                lane_pixel=jnp.asarray(t["lane_pixel"]),
                n_hit=t["n_hit"],
            )
        else:
            self._compact_cache[key] = self._compact_cache.pop(key)
        return self._compact_cache[key]

    def reset(self, camera, seed: int = 0) -> PhotonState:
        if self.compaction:
            from vpt_tpu.models import mcm_compact as C

            t = self._compact_tables(camera)
            return C.compact_reset(self.ctx(camera, seed), t["lane_ix"],
                                   t["lane_iy"], self.resolution)
        return full_reset(self.ctx(camera, seed), self.resolution)

    def render(self, state: PhotonState, camera, seed: int):
        if self.compaction:
            return self.render_many(state, camera, [seed])
        return render(state, self.ctx(camera, seed), steps=self.config.steps,
                      volume_filter=self.volume.filter)

    def render_many(self, state: PhotonState, camera, seeds):
        """K dispatches in one device program (amortized host overhead)."""
        seeds = jnp.asarray(np.asarray(seeds, np.uint32))
        if self.compaction:
            from vpt_tpu.models import mcm_compact as C

            t = self._compact_tables(camera)
            ctx = self.ctx(camera, int(np.asarray(seeds)[0]))
            state = C.render_compact_many(
                state, ctx, seeds, t["lane_ix"], t["lane_iy"],
                steps=self.config.steps, resolution=self.resolution,
                volume_filter=self.volume.filter)
            image = C.compact_image(state, t["lane_pixel"], t["hit"],
                                    t["miss"], self.resolution)
            return state, image
        return render_many(
            state, self.ctx(camera, int(np.asarray(seeds)[0])), seeds,
            steps=self.config.steps, volume_filter=self.volume.filter,
        )
