"""Single-scattering Monte-Carlo renderer (MCS).

JAX rebuild of the reference's src/glsl/renderers/MCSRenderer.glsl:
per frame, each ray Woodcock-samples one collision (``sampleDistance``,
glsl:70-87), then ratio-tracks transmittance toward a per-frame random
scattering direction (``sampleTransmittance``, glsl:89-104); shade =
diffuse * light * transmittance (glsl:122-137). Frames average with
1/frame (the uInvFrameNumber pass). The host picks the scattering
direction by rejection-sampling the unit ball per frame
(MCSRenderer.js:106-116) — here a deterministic hash-chain does the same
rejection loop so replays are exact.

The unbounded do-while collision loops become all-lanes-done early-exit
while_loops with lane masking; ``max_collisions`` is a safety cap only
(default generous — expected trips ~ extinction * path length, and the
exit fires as soon as the straggler lane finishes).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vpt_tpu.models.base import register_renderer
from vpt_tpu.ops import geometry, interp, sampling
from vpt_tpu.models.mcm import sample_environment


class MCSCtx(NamedTuple):
    inv_mvp: jax.Array
    seed_bits: jax.Array
    extinction: jax.Array
    scatter_dir: jax.Array  # (3,)
    density: jax.Array
    tf_table: jax.Array
    environment: jax.Array
    # optional (Gz, Gy, Gx, 2) super-voxel majorant table (ops/majorant,
    # built against THIS renderer's alpha curve tf[0, d, 3]): per cell a
    # (local alpha majorant, flight validity range). The all-lanes-done
    # while_loops are dominated by straggler lanes null-colliding across
    # near-empty space at the global rate (~extinction * path length trips);
    # local majorants collapse those flights. Statistically exact, opt-in
    # (per-lane RNG consumption changes, so per-seed frames differ from the
    # reference-exact default).
    majorant: jax.Array | None = None


def _majorant_lookup(ctx, px, py, pz):
    """(m, r) of the cell at normalized (px, py, pz) — one 2-wide row
    gather (mirrors mcm_spectral's majorant addressing)."""
    Gz, Gy, Gx, _ = ctx.majorant.shape
    cz = jnp.clip(jnp.floor(pz * Gz).astype(jnp.int32), 0, Gz - 1)
    cy = jnp.clip(jnp.floor(py * Gy).astype(jnp.int32), 0, Gy - 1)
    cx = jnp.clip(jnp.floor(px * Gx).astype(jnp.int32), 0, Gx - 1)
    row = jnp.take(ctx.majorant.reshape(-1, 2), (cz * Gy + cy) * Gx + cx, axis=0)
    return jnp.maximum(row[..., 0], 1e-12), row[..., 1]


def _sample_tf(ctx, px, py, pz, volume_filter):
    d = interp.sample_volume(ctx.density, px, py, pz, volume_filter)
    return interp.sample_tex2d(ctx.tf_table, d, jnp.zeros_like(d))


def _woodcock_distance(rng, ctx, frm, to, max_collisions, volume_filter):
    """sampleDistance: free-flight until a real collision or escape.

    Returns (rng, dist). Lanes stop advancing (and drawing) once done —
    draw-order parity with the scalar do-while. The loop is a while_loop
    that exits as soon as EVERY lane is done (the reference's do-while is
    unbounded, glsl:70-87): typical frames finish in a few trips instead of
    always paying ``max_collisions``, and long straggler tails are no
    longer silently truncated — ``max_collisions`` is a safety cap only.
    """
    fx, fy, fz = frm
    tx, ty, tz = to
    max_dist = jnp.sqrt((tx - fx) ** 2 + (ty - fy) ** 2 + (tz - fz) ** 2)

    def cond(carry):
        i, rng, dist, done = carry
        return (i < max_collisions) & ~jnp.all(done)

    def body(carry):
        i, rng, dist, done = carry
        active = ~done
        if ctx.majorant is not None:
            t0 = dist / jnp.maximum(max_dist, 1e-30)
            m, cap = _majorant_lookup(
                ctx, fx + (tx - fx) * t0, fy + (ty - fy) * t0,
                fz + (tz - fz) * t0)
            rng, step = sampling.draw_exponential(rng, active,
                                                  ctx.extinction * m)
            capped = step >= cap
            step = jnp.minimum(step, cap)
        else:
            rng, step = sampling.draw_exponential(rng, active, ctx.extinction)
            capped = jnp.zeros(step.shape, bool)
        dist2 = jnp.where(active, dist + step, dist)
        escaped = active & (dist2 > max_dist)
        still = active & ~escaped & ~capped
        t = dist2 / jnp.maximum(max_dist, 1e-30)
        tf4 = _sample_tf(ctx, fx + (tx - fx) * t, fy + (ty - fy) * t,
                         fz + (tz - fz) * t, volume_filter)
        rng, u = sampling.draw(rng, still)
        alpha = tf4[..., 3]
        if ctx.majorant is not None:
            # spatially varying delta tracking: accept a tentative collision
            # with probability alpha / m (<= 1 by the builder's bound);
            # capped flights are pure advances (exact by memorylessness)
            alpha = jnp.minimum(alpha / m, 1.0)
        collided = still & (u < alpha)
        return i + 1, rng, dist2, done | escaped | collided

    zeros = jnp.zeros_like(max_dist)
    _, rng, dist, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), rng, zeros, zeros.astype(bool))
    )
    return rng, dist, max_dist


def _woodcock_transmittance(rng, mask, ctx, frm, to, max_collisions, volume_filter):
    """sampleTransmittance: residual-ratio style product of (1 - alpha).
    Early-exits when all lanes are done, like _woodcock_distance."""
    fx, fy, fz = frm
    tx, ty, tz = to
    max_dist = jnp.sqrt((tx - fx) ** 2 + (ty - fy) ** 2 + (tz - fz) ** 2)

    def cond(carry):
        i, rng, dist, trans, done = carry
        return (i < max_collisions) & ~jnp.all(done)

    def body(carry):
        i, rng, dist, trans, done = carry
        active = mask & ~done
        if ctx.majorant is not None:
            t0 = dist / jnp.maximum(max_dist, 1e-30)
            m, cap = _majorant_lookup(
                ctx, fx + (tx - fx) * t0, fy + (ty - fy) * t0,
                fz + (tz - fz) * t0)
            rng, step = sampling.draw_exponential(rng, active,
                                                  ctx.extinction * m)
            capped = step >= cap
            step = jnp.minimum(step, cap)
        else:
            rng, step = sampling.draw_exponential(rng, active, ctx.extinction)
            capped = jnp.zeros(step.shape, bool)
        dist2 = jnp.where(active, dist + step, dist)
        escaped = active & (dist2 > max_dist)
        still = active & ~escaped & ~capped
        t = dist2 / jnp.maximum(max_dist, 1e-30)
        tf4 = _sample_tf(ctx, fx + (tx - fx) * t, fy + (ty - fy) * t,
                         fz + (tz - fz) * t, volume_filter)
        alpha = tf4[..., 3]
        if ctx.majorant is not None:
            # ratio tracking against the local majorant: the per-collision
            # factor (1 - alpha/m) at rate ext*m has the same expectation
            # exp(-ext * integral alpha) as (1 - alpha) at rate ext
            alpha = jnp.minimum(alpha / m, 1.0)
        trans2 = jnp.where(still, trans * (1.0 - alpha), trans)
        return i + 1, rng, dist2, trans2, done | escaped

    zeros = jnp.zeros_like(max_dist)
    done0 = ~mask  # lanes outside the mask never run
    _, rng, _, trans, _ = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), rng, zeros, jnp.ones_like(max_dist), done0),
    )
    return rng, trans


def _mcs_frame_impl(ctx: MCSCtx, resolution: int, max_collisions: int = 1024,
                    volume_filter: str = "linear"):
    """One single-scattering sample per pixel -> (H, W, 4) RGBA frame."""
    from vpt_tpu.models.raymarch import camera_rays

    frm, to = camera_rays(resolution, ctx.inv_mvp)
    ddx, ddy, ddz = geometry.normalize3(to[0] - frm[0], to[1] - frm[1], to[2] - frm[2])
    tn, tf_ = geometry.intersect_cube(
        frm[0], frm[1], frm[2], to[0] - frm[0], to[1] - frm[1], to[2] - frm[2]
    )
    tn = jnp.maximum(tn, 0.0)
    tf_ = jnp.maximum(tf_, 0.0)
    miss = tn >= tf_

    entry = (
        frm[0] + (to[0] - frm[0]) * tn,
        frm[1] + (to[1] - frm[1]) * tn,
        frm[2] + (to[2] - frm[2]) * tn,
    )
    exit_ = (
        frm[0] + (to[0] - frm[0]) * tf_,
        frm[1] + (to[1] - frm[1]) * tf_,
        frm[2] + (to[2] - frm[2]) * tf_,
    )

    # per-pixel chain seeded from the screen-uv float bits (glsl:114)
    iy = jax.lax.broadcasted_iota(jnp.float32, (resolution, resolution), 0)
    ix = jax.lax.broadcasted_iota(jnp.float32, (resolution, resolution), 1)
    u = ((ix + 0.5) / resolution).astype(jnp.float32)
    v = ((iy + 0.5) / resolution).astype(jnp.float32)
    rng = sampling.hash3(
        jax.lax.bitcast_convert_type(u, jnp.uint32),
        jax.lax.bitcast_convert_type(v, jnp.uint32),
        jnp.broadcast_to(ctx.seed_bits, u.shape),
    )

    rng, dist, max_dist = _woodcock_distance(
        rng, ctx, entry, exit_, max_collisions, volume_filter
    )
    escaped = dist > max_dist

    t = dist / jnp.maximum(max_dist, 1e-30)
    scat = (
        entry[0] + (exit_[0] - entry[0]) * t,
        entry[1] + (exit_[1] - entry[1]) * t,
        entry[2] + (exit_[2] - entry[2]) * t,
    )
    sd = ctx.scatter_dir
    _, stf = geometry.intersect_cube(
        scat[0], scat[1], scat[2],
        jnp.broadcast_to(sd[0], t.shape), jnp.broadcast_to(sd[1], t.shape),
        jnp.broadcast_to(sd[2], t.shape),
    )
    stf = jnp.maximum(stf, 0.0)
    light_exit = (scat[0] + sd[0] * stf, scat[1] + sd[1] * stf, scat[2] + sd[2] * stf)

    diffuse = _sample_tf(ctx, *scat, volume_filter)
    # the light is one env sample at the frame's scattering direction (vec4)
    light3 = sample_environment(ctx.environment, sd[0], sd[1], sd[2])
    light = jnp.concatenate([light3, jnp.ones((1,), light3.dtype)])
    need_trans = (~miss) & (~escaped)
    rng, trans = _woodcock_transmittance(
        rng, need_trans, ctx, scat, light_exit, max_collisions, volume_filter
    )

    shaded = diffuse * light * trans[..., None]
    env = sample_environment(ctx.environment, ddx, ddy, ddz)
    env4 = jnp.concatenate([env, jnp.ones_like(env[..., :1])], axis=-1)
    use_env = (miss | escaped)[..., None]
    return jnp.where(use_env, env4, shaded)


mcs_frame = functools.partial(
    jax.jit, static_argnames=("resolution", "max_collisions", "volume_filter")
)(_mcs_frame_impl)


@functools.partial(
    jax.jit,
    static_argnames=("resolution", "max_collisions", "volume_filter"),
    donate_argnames=("acc", "frame"),
)
def mcs_frames(ctx: MCSCtx, seeds, scatter_dirs, acc, frame,
               resolution: int, max_collisions: int = 1024,
               volume_filter: str = "linear"):
    """K frames in one device program: lax.scan over (seed, scatter_dir)
    pairs with the running frame average folded in (the MCS analog of
    mcm_spectral.render_many — amortizes per-frame host dispatch).
    Matches K sequential ``mcs_frame`` + average steps to float rounding
    (identical draws; XLA fuses the running average differently)."""

    def body(carry, inp):
        acc, frame = carry
        seed, sd = inp
        c = ctx._replace(seed_bits=seed, scatter_dir=sd)
        img = _mcs_frame_impl(c, resolution, max_collisions, volume_filter)
        frame = frame + 1
        acc = acc + (img - acc) / frame.astype(jnp.float32)
        return (acc, frame), None

    (acc, frame), _ = jax.lax.scan(body, (acc, frame), (seeds, scatter_dirs))
    return acc, frame


def _host_scatter_direction(seed: int):
    """Deterministic rejection-sampled unit-ball direction
    (MCSRenderer.js:106-116, with a hash chain instead of Math.random)."""
    state = np.uint32(seed ^ 0x9E3779B9)

    def nxt(s):
        from vpt_tpu.reference.oracle import pcg_hash

        s = pcg_hash(s)
        return s, float(s) / float(0xFFFFFFFF)

    while True:
        state, x = nxt(state)
        state, y = nxt(state)
        state, z = nxt(state)
        x, y, z = x * 2 - 1, y * 2 - 1, z * 2 - 1
        n = (x * x + y * y + z * z) ** 0.5
        if n <= 1 and n > 1e-6:
            return np.array([x / n, y / n, z / n], np.float32)


@register_renderer("mcs")
class MCSRenderer:
    def __init__(self, volume, tf2d=None, environment=None,
                 extinction: float = 1.0, max_collisions: int = 1024,
                 resolution: int = 512, majorant_blocks: int | None = None,
                 persistent: bool = False, steps: int = 32,
                 streams: int = 1):
        """``persistent=True`` switches render/render_many to the
        persistent-lane megakernel (MCSPersistentState): same converged
        expectation, ~20-40x the throughput of the reference-exact
        frame loops (which straggler-gate every frame on the slowest
        lane's collision chain); ``steps`` = lane iterations per dispatch
        in that mode."""
        self.persistent = persistent
        self.steps = steps
        self.streams = streams
        from vpt_tpu.scene.tf import TransferFunction2D

        self.volume = volume
        self.tf2d = tf2d or TransferFunction2D.grayscale_ramp()
        self.extinction = extinction
        self.max_collisions = max_collisions
        self.resolution = resolution
        if environment is None:
            environment = np.ones((1, 1, 3), np.float32)
        density = volume.density
        tf_table = self.tf2d.rasterize()
        # optional super-voxel majorants, built from the RAW tables before
        # packing. MCS samples its alpha at tf[v=0][u=density][3], i.e. the
        # alpha curve lives on the x axis of row 0 — remap it onto the
        # builder's density-rows-x-wavelength convention ((W, 1) table whose
        # row k carries alpha(density ~ texel k)), which makes the builder's
        # row-touch interval logic coincide with the sampler's column-touch
        # logic exactly.
        maj = None
        if majorant_blocks is not None:
            from vpt_tpu.ops.majorant import build_majorant_grid

            raw_tf = np.asarray(tf_table, np.float32)
            curve = raw_tf[0, :, 3]  # alpha(density) along x of row 0
            tf_equiv = np.zeros((curve.shape[0], 1, 4), np.float32)
            tf_equiv[:, 0, 1] = curve
            maj = jnp.asarray(build_majorant_grid(
                np.asarray(volume.density), tf_equiv, extinction,
                block=majorant_blocks))
        if volume.filter in ("linear", "quasicubic"):
            density = interp.pack_volume_auto(density, "full")
            tf_table = interp.pack_tex2d_corners(tf_table)
        self._static_ctx = dict(
            extinction=jnp.float32(extinction),
            density=(density if isinstance(density, interp.PackedVolume)
                     else jnp.asarray(density)),
            tf_table=jnp.asarray(tf_table),
            environment=jnp.asarray(environment, jnp.float32),
            majorant=maj,
        )

    def ctx(self, camera, seed: int) -> MCSCtx:
        return MCSCtx(
            inv_mvp=jnp.asarray(camera.inverse_mvp()),
            seed_bits=jnp.uint32(np.uint32(seed)),
            scatter_dir=jnp.asarray(_host_scatter_direction(seed)),
            **self._static_ctx,
        )

    def reset(self, camera, seed: int = 0):
        if self.persistent:
            n = self.resolution
            shape = ((self.streams, n, n) if self.streams > 1 else (n, n))
            # distinct buffers per field: the dispatch donates the state, and
            # aliased leaves would be donated twice (an XLA error)
            z = lambda: jnp.zeros(shape, jnp.float32)
            return MCSPersistentState(
                phase=jnp.zeros(shape, bool), dist=z(),
                trans=jnp.ones(shape, jnp.float32),
                sdx=z(), sdy=z(), sdz=jnp.ones(shape, jnp.float32),
                smax=z(), scx=z(), scy=z(), scz=z(),
                dr=z(), dg=z(), db=z(), da=z(),
                acc=jnp.zeros(shape + (4,), jnp.float32),
                samples=jnp.zeros(shape, jnp.int32))
        return dict(
            acc=jnp.zeros((self.resolution, self.resolution, 4), jnp.float32),
            frame=jnp.zeros((), jnp.int32),
        )

    def _persistent_image(self, state):
        """Sample-count-weighted mean over streams (streams have unequal
        completed-sample counts at any finite step)."""
        if self.streams == 1:
            return state.acc[..., :3]
        w = state.samples.astype(jnp.float32)[..., None]
        tot = jnp.maximum(jnp.sum(w, axis=0), 1.0)
        return jnp.sum(state.acc[..., :3] * w, axis=0) / tot

    def render(self, state, camera, seed: int):
        if self.persistent:
            state = mcs_persistent_dispatch(
                state, self.ctx(camera, seed), resolution=self.resolution,
                steps=self.steps, volume_filter=self.volume.filter,
                streams=self.streams)
            return state, self._persistent_image(state)
        frame_img = mcs_frame(
            self.ctx(camera, seed), resolution=self.resolution,
            max_collisions=self.max_collisions, volume_filter=self.volume.filter,
        )
        frame = state["frame"] + 1
        acc = state["acc"] + (frame_img - state["acc"]) / frame.astype(jnp.float32)
        return dict(acc=acc, frame=frame), acc[..., :3]

    def render_many(self, state, camera, seeds):
        """K frames in one device program (mcs_frames): per-frame seeds and
        host-derived scatter directions ride a scan."""
        seeds = np.asarray(seeds, np.uint32)
        if self.persistent:
            state = mcs_persistent_many(
                state, self.ctx(camera, int(seeds[0])), jnp.asarray(seeds),
                resolution=self.resolution, steps=self.steps,
                volume_filter=self.volume.filter, streams=self.streams)
            return state, self._persistent_image(state)
        dirs = np.stack([_host_scatter_direction(int(s)) for s in seeds])
        acc, frame = mcs_frames(
            self.ctx(camera, int(seeds[0])),
            jnp.asarray(seeds), jnp.asarray(dirs),
            state["acc"], state["frame"],
            resolution=self.resolution, max_collisions=self.max_collisions,
            volume_filter=self.volume.filter,
        )
        return dict(acc=acc, frame=frame), acc[..., :3]


# ==========================================================================
# Persistent-lane MCS — the fixed-trip fast path
# ==========================================================================

class MCSPersistentState(NamedTuple):
    """Per-lane single-scatter state machine (one persistent lane per pixel).

    The frame-based path above is reference-exact but straggler-gated:
    each frame runs two while_loops that every lane waits out, so every
    frame pays the slowest lane's collision chain, and a finished lane idles
    until the slowest one exits. Persistent lanes are the spectral
    megakernel's answer applied to MCS: a fixed-trip fori_loop in which
    every lane that finishes a sample deposits into its incremental mean and
    immediately starts the next one — zero straggler wait, every lane-step
    useful.

    Estimator: same single-scattering expectation as the reference
    (Woodcock distance -> diffuse * light * ratio-tracked transmittance;
    MCSRenderer.glsl:70-137) with one variance-structure difference: the
    scattering (light) direction is drawn PER SAMPLE on the lane
    (uniform sphere — the same unit-ball-normalized distribution the host
    rejection sampler produces) instead of once per frame for all pixels,
    so converged images match (test_mcs_persistent_matches_frames) but
    per-frame images are not comparable seed-to-seed.
    """

    phase: jax.Array    # bool: False = distance sampling, True = shadow ray
    dist: jax.Array     # world distance traveled in the current segment
    trans: jax.Array    # running transmittance (shadow phase)
    sdx: jax.Array      # per-sample scatter (light) direction
    sdy: jax.Array
    sdz: jax.Array
    smax: jax.Array     # shadow segment length
    scx: jax.Array      # scatter point
    scy: jax.Array
    scz: jax.Array
    dr: jax.Array       # diffuse RGBA cached at the scatter point
    dg: jax.Array
    db: jax.Array
    da: jax.Array
    acc: jax.Array      # (H, W, 4) incremental-mean RGBA
    samples: jax.Array  # int32 per-lane completed samples


def _mcs_persistent_dispatch_impl(state: MCSPersistentState, ctx: MCSCtx,
                                  resolution: int, steps: int,
                                  volume_filter: str, streams: int = 1):
    """``steps`` persistent lane iterations (one device program).

    ``streams``: S independent sample chains per pixel (lane shape
    (S, H, W)) — the spectral kernel's lane-widening trick: per-gather-op
    cost is strongly sub-linear in lane count, so S>1 multiplies samples
    per wall-clock nearly for free at moderate resolutions. Stream s seeds
    its chain as pixel row (y + s*resolution), the chain a taller
    framebuffer would use."""
    from vpt_tpu.models.raymarch import camera_rays

    frm, to = camera_rays(resolution, ctx.inv_mvp)
    ddx, ddy, ddz = geometry.normalize3(
        to[0] - frm[0], to[1] - frm[1], to[2] - frm[2])
    tn, tf_ = geometry.intersect_cube(
        frm[0], frm[1], frm[2], to[0] - frm[0], to[1] - frm[1], to[2] - frm[2])
    tn = jnp.maximum(tn, 0.0)
    tf_ = jnp.maximum(tf_, 0.0)
    # miss guard (frame path mcs.py above / MCSRenderer.glsl:112-116): rays
    # that never enter the cube have tn >= tf_ after clamping; without the
    # guard entry/exit swap and max_dist > 0, so miss lanes would Woodcock-
    # march a reversed out-of-cube segment sampling clamped border voxels.
    # Forcing max_dist = 0 makes their first step escape -> env deposit.
    miss = tn >= tf_
    entry = (frm[0] + (to[0] - frm[0]) * tn,
             frm[1] + (to[1] - frm[1]) * tn,
             frm[2] + (to[2] - frm[2]) * tn)
    exit_ = (frm[0] + (to[0] - frm[0]) * tf_,
             frm[1] + (to[1] - frm[1]) * tf_,
             frm[2] + (to[2] - frm[2]) * tf_)
    seg = (exit_[0] - entry[0], exit_[1] - entry[1], exit_[2] - entry[2])
    max_dist = jnp.where(
        miss, 0.0, jnp.sqrt(seg[0] ** 2 + seg[1] ** 2 + seg[2] ** 2))
    inv_md = 1.0 / jnp.maximum(max_dist, 1e-30)
    rdx, rdy, rdz = seg[0] * inv_md, seg[1] * inv_md, seg[2] * inv_md
    env3 = sample_environment(ctx.environment, ddx, ddy, ddz)
    env4 = jnp.concatenate([env3, jnp.ones_like(env3[..., :1])], axis=-1)

    lane_shape = ((streams, resolution, resolution) if streams > 1
                  else (resolution, resolution))
    if streams > 1:
        bc = lambda a: jnp.broadcast_to(a[None], lane_shape)
        entry = tuple(bc(e) for e in entry)
        max_dist = bc(max_dist)
        rdx, rdy, rdz = bc(rdx), bc(rdy), bc(rdz)
        env4 = jnp.broadcast_to(env4[None],
                                lane_shape + (env4.shape[-1],))
        iy = jax.lax.broadcasted_iota(jnp.float32, lane_shape, 1)
        ix = jax.lax.broadcasted_iota(jnp.float32, lane_shape, 2)
        s_idx = jax.lax.broadcasted_iota(jnp.float32, lane_shape, 0)
        seed_row = iy + s_idx * resolution
    else:
        iy = jax.lax.broadcasted_iota(jnp.float32, lane_shape, 0)
        ix = jax.lax.broadcasted_iota(jnp.float32, lane_shape, 1)
        seed_row = iy
    u = ((ix + 0.5) / resolution).astype(jnp.float32)
    v = ((seed_row + 0.5) / resolution).astype(jnp.float32)
    rng0 = sampling.hash3(
        jax.lax.bitcast_convert_type(u, jnp.uint32),
        jax.lax.bitcast_convert_type(v, jnp.uint32),
        jnp.broadcast_to(ctx.seed_bits, u.shape))

    all_mask = jnp.ones(u.shape, bool)

    def body(_, carry):
        p, rng = carry
        shadow = p.phase
        # current segment: camera segment (phase 0) or shadow ray (phase 1)
        bx = jnp.where(shadow, p.scx, entry[0])
        by = jnp.where(shadow, p.scy, entry[1])
        bz = jnp.where(shadow, p.scz, entry[2])
        dx = jnp.where(shadow, p.sdx, rdx)
        dy = jnp.where(shadow, p.sdy, rdy)
        dz = jnp.where(shadow, p.sdz, rdz)
        seg_max = jnp.where(shadow, p.smax, max_dist)

        if ctx.majorant is not None:
            m, cap = _majorant_lookup(
                ctx, bx + dx * p.dist, by + dy * p.dist, bz + dz * p.dist)
            rng, step = sampling.draw_exponential(rng, all_mask,
                                                  ctx.extinction * m)
            capped = step >= cap
            step = jnp.minimum(step, cap)
        else:
            m = jnp.ones_like(p.dist)
            rng, step = sampling.draw_exponential(rng, all_mask, ctx.extinction)
            capped = jnp.zeros(step.shape, bool)

        dist2 = p.dist + step
        escaped = dist2 > seg_max
        px = bx + dx * dist2
        py = by + dy * dist2
        pz = bz + dz * dist2
        tf4 = _sample_tf(ctx, px, py, pz, volume_filter)
        alpha = jnp.minimum(tf4[..., 3] / m, 1.0)
        tentative = (~escaped) & (~capped)
        # the wheel decides real collisions in the DISTANCE phase only; the
        # shadow phase is ratio tracking — every tentative collision
        # multiplies (1 - alpha), no acceptance draw (_woodcock_transmittance)
        rng, wheel = sampling.draw(rng, all_mask & ~shadow)

        # ---- phase-0 collision: become a shadow ray --------------------
        scatter = (~shadow) & tentative & (wheel < alpha)
        rng, (nsx, nsy, nsz) = sampling.draw_sphere(rng, all_mask)
        _, sfar = geometry.intersect_cube(
            px, py, pz, nsx, nsy, nsz)
        sfar = jnp.maximum(sfar, 0.0)

        # ---- deposits --------------------------------------------------
        esc0 = (~shadow) & escaped              # missed / crossed: env color
        esc1 = shadow & escaped                 # shadow ray out: shade
        light3 = sample_environment(ctx.environment, p.sdx, p.sdy, p.sdz)
        shaded = jnp.stack([p.dr * light3[..., 0], p.dg * light3[..., 1],
                            p.db * light3[..., 2], p.da], axis=-1) \
            * p.trans[..., None]
        deposit = esc0 | esc1
        value = jnp.where(esc0[..., None], env4, shaded)
        samples = p.samples + deposit.astype(jnp.int32)
        denom = jnp.maximum(samples, 1).astype(jnp.float32)[..., None]
        acc = jnp.where(deposit[..., None],
                        p.acc + (value - p.acc) / denom, p.acc)

        # ---- next lane state -------------------------------------------
        shadow_hit = shadow & tentative         # ratio-tracking factor
        trans = jnp.where(shadow_hit, p.trans * (1.0 - alpha), p.trans)
        new_phase = jnp.where(deposit, False, jnp.where(scatter, True, shadow))
        new_dist = jnp.where(deposit | scatter, 0.0, dist2)
        trans = jnp.where(scatter, 1.0, jnp.where(deposit, 1.0, trans))
        sel = lambda a, b: jnp.where(scatter, a, b)
        out = MCSPersistentState(
            phase=new_phase, dist=new_dist, trans=trans,
            sdx=sel(nsx, p.sdx), sdy=sel(nsy, p.sdy), sdz=sel(nsz, p.sdz),
            smax=sel(sfar, p.smax),
            scx=sel(px, p.scx), scy=sel(py, p.scy), scz=sel(pz, p.scz),
            dr=sel(tf4[..., 0], p.dr), dg=sel(tf4[..., 1], p.dg),
            db=sel(tf4[..., 2], p.db), da=sel(tf4[..., 3], p.da),
            acc=acc, samples=samples)
        return (out, rng)

    state, _ = jax.lax.fori_loop(0, steps, body, (state, rng0))
    return state


mcs_persistent_dispatch = functools.partial(
    jax.jit,
    static_argnames=("resolution", "steps", "volume_filter", "streams"),
    donate_argnames=("state",),
)(_mcs_persistent_dispatch_impl)


@functools.partial(
    jax.jit,
    static_argnames=("resolution", "steps", "volume_filter", "streams"),
    donate_argnames=("state",))
def mcs_persistent_many(state: MCSPersistentState, ctx: MCSCtx, seeds,
                        resolution: int, steps: int,
                        volume_filter: str = "linear", streams: int = 1):
    """K dispatches in one device program (per-dispatch reseed, like
    mcm_spectral.render_many)."""
    def body(p, seed):
        p = _mcs_persistent_dispatch_impl(
            p, ctx._replace(seed_bits=seed), resolution, steps,
            volume_filter, streams)
        return p, None

    state, _ = jax.lax.scan(body, state, seeds)
    return state
