"""Spectral multiple-scattering delta-tracking path tracer (the north star).

JAX rebuild of the semantics of
/root/reference/src/wgsl/renderers/MCMSpectralComputeRenderer.wgsl:107-326 and
its host /root/reference/src/js/renderers/WebGPUMCMSpectralComputeRenderer.js.

Design (vs the reference's one-thread-per-pixel megakernel):
  - photon state is a pytree of (H, W) lane arrays (SoA) resident on device;
    spectral bins are a leading (B, H, W) axis — compile-time B like the
    reference's MAX_N_BINS
  - the per-pixel branch divergence (out-of-bounds / absorb / scatter / null)
    becomes lane masking: every lane evaluates every branch, `jnp.where`
    selects — branch bodies are cheap, so masking beats wavefront splitting
  - the per-thread hash-chain RNG advances under the same masks, reproducing
    the reference's data-dependent draw order bit-exactly per lane (see
    ops/sampling.py); seeds depend only on global pixel coords + frame seed,
    so renders are bit-identical across device meshes
  - the `steps` Woodcock loop is a fori_loop inside one jit (one "dispatch");
    progressive accumulation = repeated dispatches with donated state

Known reference quirks preserved: radiance init to 1.0; y-flipped screen
coords; light gain 5.0; volume sampled (clamped) before the OOB test.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vpt_tpu.models.base import register_renderer
from vpt_tpu.ops import geometry, interp, sampling
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig

EPS = 1e-5


class SpectralState(NamedTuple):
    """Per-pixel photon state (the reference's PhotonSpectral storage buffer)."""

    px: jax.Array  # (H, W) f32 position
    py: jax.Array
    pz: jax.Array
    dx: jax.Array  # (H, W) f32 direction
    dy: jax.Array
    dz: jax.Array
    bounces: jax.Array  # (H, W) i32
    samples: jax.Array  # (H, W) i32
    bin: jax.Array  # (H, W) i32
    wavelength: jax.Array  # (H, W) f32
    radiance: jax.Array  # (B, H, W) f32
    transmittance: jax.Array  # (B, H, W) f32


class SpectralCtx(NamedTuple):
    """Dynamic render resources (one jit signature per static config)."""

    inv_mvp: jax.Array  # (4, 4) f32
    seed_bits: jax.Array  # () uint32 — frame seed bit pattern
    extinction: jax.Array  # () f32
    blur: jax.Array  # () f32
    max_bounces: jax.Array  # () i32
    light_direction: jax.Array  # (3,) f32
    density: jax.Array  # raw (D,H,W) f32 | interp.PackedVolume (fast path)
    material_tf: jax.Array  # (256, 256, 4) f32
    light_spectrum: jax.Array  # (256,) f32
    boundaries: jax.Array  # (B+1,) f32 bin boundaries
    bin_xyz: jax.Array  # (3, B) f32 per-bin CIE coefficients
    # optional equirect environment map (He, We, 3); None = directional/
    # isotropic light (the reference's active escape path). When set, escape
    # radiance comes from the env map instead — the reference has this path
    # written but commented out (MCMSpectralComputeRenderer.wgsl:49-60,
    # :143-146); here it is a first-class opt-in mode.
    environment: jax.Array | None = None
    # optional (Gz, Gy, Gx, 2) super-voxel majorant table (ops/majorant):
    # per cell (majorant alpha, flight validity range). None = the
    # reference-exact global majorant. When set, free flights sample at the
    # local rate and cap at the range — statistically exact (image-level
    # parity), far fewer steps per path through empty/thin regions.
    majorant: jax.Array | None = None


def _pixel_grid(resolution, streams: int = 1):
    """Per-lane pixel coordinates, optionally with S independent sample
    streams per pixel (lane shape (S, H, W)).

    Streams keep S photons in flight per pixel (more lanes per dispatch).
    Stream s seeds its RNG chain as pixel row (y + s*resolution) — exactly
    the chain a taller framebuffer would use, so stream 0 is bit-identical
    to the reference layout and renders stay mesh-shape/stream-count
    deterministic.

    Returns (ix, iy, seed_iy): screen coords + the seeding row.
    """
    if streams == 1:
        iy = jax.lax.broadcasted_iota(jnp.uint32, (resolution, resolution), 0)
        ix = jax.lax.broadcasted_iota(jnp.uint32, (resolution, resolution), 1)
        return ix, iy, iy
    shape = (streams, resolution, resolution)
    s = jax.lax.broadcasted_iota(jnp.uint32, shape, 0)
    iy = jax.lax.broadcasted_iota(jnp.uint32, shape, 1)
    ix = jax.lax.broadcasted_iota(jnp.uint32, shape, 2)
    return ix, iy, iy + s * jnp.uint32(resolution)


def _wavelength_to_bin(lam, boundaries, n_bins):
    """bin = number of internal boundaries b_1..b_{n-1} that are <= lam
    (equivalent to the reference's first-crossing scan, wgsl:283-289)."""
    b = jnp.zeros(lam.shape, jnp.int32)
    for i in range(1, n_bins):
        b = b + (lam >= boundaries[i]).astype(jnp.int32)
    return b


def _respawn(state_rng, mask, sx, sy, ctx: SpectralCtx, n_bins):
    """PhotonSpectral_reset (wgsl:249-266): new camera ray + hero wavelength.

    Draw order: disk(2) + square(2) inside unprojectRand, then wavelength(1).
    Returns (state_rng, dict of new lane values).
    """
    inv_res = 1.0 / jnp.float32(sx.shape[-1])
    state_rng, (fx, fy, fz), (tx, ty, tz) = geometry.unproject_rand(
        state_rng, mask, sx, sy, ctx.inv_mvp, inv_res, ctx.blur
    )
    ndx, ndy, ndz = geometry.normalize3(tx - fx, ty - fy, tz - fz)
    tnear, _ = geometry.intersect_cube(fx, fy, fz, ndx, ndy, ndz)
    tnear = jnp.maximum(tnear, 0.0)
    npx = fx + tnear * ndx
    npy = fy + tnear * ndy
    npz = fz + tnear * ndz

    lo = ctx.boundaries[0]
    hi = ctx.boundaries[n_bins]
    state_rng, u = sampling.draw(state_rng, mask)
    lam = u * (hi - lo) + lo
    nbin = _wavelength_to_bin(lam, ctx.boundaries, n_bins)
    return state_rng, dict(
        px=npx, py=npy, pz=npz, dx=ndx, dy=ndy, dz=ndz,
        bounces=jnp.zeros_like(nbin), wavelength=lam, bin=nbin,
    )


def _sample_environment(ctx: SpectralCtx, dx, dy, dz, lam):
    """sample_environment_map (wgsl:49-60): equirect lookup x gain 2.7 with
    3-band wavelength -> RGB-channel selection (lambda<500 -> B, <600 -> G,
    else R). Keeps the reference's equirect mapping quirk (its own
    "TODO: Why shouldn't y be negated" comment). The dormant reference call
    also multiplied by transmittance[bin], which the spectral kernel keeps
    constant at 1.0 — identity, so it is omitted here too."""
    inv_pi = jnp.float32(1.0 / np.pi)
    u = jnp.arctan2(dx, -dz) * inv_pi * 0.5 + 0.5
    v = jnp.arcsin(-dy) * 2.0 * inv_pi * 0.5 + 0.5
    color = interp.sample_tex2d(ctx.environment, u, v) * 2.7
    return jnp.where(
        lam < 500.0, color[..., 2],
        jnp.where(lam < 600.0, color[..., 1], color[..., 0]),
    )


def _sample_light(ctx: SpectralCtx, dx, dy, dz, lam, raw=None):
    """sample_light (wgsl:62-73): 1D light spectrum x5, optional cosine lobe.

    ``raw``: pre-fetched spectrum value (from the fused TF+light gather);
    falls back to a standalone lookup when not provided."""
    if raw is None:
        t = (lam - 400.0) / 300.0
        raw = interp.sample_tex1d(ctx.light_spectrum, t)
    intensity = raw * 5.0
    ld = ctx.light_direction
    norm = jnp.sqrt(jnp.sum(ld * ld))
    ldn = ld / jnp.maximum(norm, 1e-30)
    directional = jnp.maximum((dx * ldn[0] + dy * ldn[1] + dz * ldn[2]) * intensity, 0.0)
    return jnp.where(norm < EPS, intensity, directional)


@functools.partial(jax.jit, static_argnames=("resolution", "n_bins", "streams"))
def full_reset(ctx: SpectralCtx, resolution: int, n_bins: int,
               streams: int = 1) -> SpectralState:
    """The reset dispatch (wgsl:213-231): fresh photons, radiance = 1."""
    ix, iy, seed_iy = _pixel_grid(resolution, streams)
    sx, sy = geometry.screen_position(ix, iy, 1.0 / resolution)
    rng = sampling.seed_state(ix, seed_iy, ctx.seed_bits)
    lane_shape = ix.shape
    mask = jnp.ones(lane_shape, bool)
    rng, new = _respawn(rng, mask, sx, sy, ctx, n_bins)
    shape = (n_bins,) + lane_shape
    return SpectralState(
        px=new["px"], py=new["py"], pz=new["pz"],
        dx=new["dx"], dy=new["dy"], dz=new["dz"],
        bounces=jnp.zeros(lane_shape, jnp.int32),
        samples=jnp.zeros(lane_shape, jnp.int32),
        bin=new["bin"], wavelength=new["wavelength"],
        radiance=jnp.ones(shape, jnp.float32),
        transmittance=jnp.ones(shape, jnp.float32),
    )


def _surrogate(prob, taken):
    """Score-function surrogate factor: numerically exactly 1.0 where taken,
    but carrying d(log P)/d(params) under autodiff (REINFORCE-through-
    the-event-wheel; enables radiative-backprop-style gradients without a
    tape). Guarded against P -> 0 on the taken branch."""
    safe = jnp.maximum(prob, 1e-12)
    return jnp.where(taken, safe / jax.lax.stop_gradient(safe), 1.0)


def _render_body(p: SpectralState, rng, score, sx, sy, ctx: SpectralCtx,
                 n_bins, volume_filter, diff: bool, sample_volume_fn=None,
                 collect: bool = False):
    """One Woodcock iteration over all lanes (wgsl loop body :123-164).

    ``score``: per-lane REINFORCE weight (None when not differentiating) —
    the running product of P_event/stop_grad(P_event) since the lane's last
    respawn. Forward values are bit-identical with and without it.

    ``collect``: additionally return the step's internals (the quantities
    the hand-derived path-replay backward needs, kernels/spectral_backward);
    the single source of truth for forward and replay is this function.
    """
    all_mask = jnp.ones(p.px.shape, bool)

    # free flight
    maj = None
    if ctx.majorant is not None:
        if collect:
            raise NotImplementedError(
                "the packed-PRB taped backward does not support the "
                "super-voxel majorant mode; use the autodiff surrogate "
                "(render_sequence_diff / fit_spectral method='autodiff') "
                "for majorant-mode gradients"
            )
        # local majorant lookup: one 2-wide row gather into a ~MB table
        Gz, Gy, Gx, _ = ctx.majorant.shape
        cz = jnp.clip(jnp.floor(p.pz * Gz).astype(jnp.int32), 0, Gz - 1)
        cy = jnp.clip(jnp.floor(p.py * Gy).astype(jnp.int32), 0, Gy - 1)
        cx = jnp.clip(jnp.floor(p.px * Gx).astype(jnp.int32), 0, Gx - 1)
        row = jnp.take(ctx.majorant.reshape(-1, 2), (cz * Gy + cy) * Gx + cx, axis=0)
        maj = jnp.maximum(row[..., 0], 1e-12)
        flight_cap = row[..., 1]
        rng, dist = sampling.draw_exponential(rng, all_mask, ctx.extinction * maj)
        # flight >= cap: pure advance by the cap and resample next step —
        # exact by the exponential's memorylessness (no event, no gathers
        # consumed conceptually; the masked megakernel still issues them)
        capped = dist >= flight_cap
        dist = jnp.minimum(dist, flight_cap)
    else:
        rng, dist = sampling.draw_exponential(rng, all_mask, ctx.extinction)
    if diff:
        # Score-form free flight: the sampled distance feeds the
        # *discontinuous* OOB test, so the reparameterized (pathwise)
        # d(dist)/d(extinction) channel is biased — it misses the boundary
        # term entirely (finite differences expose this: a homogeneous
        # medium has zero pathwise extinction gradient but a real one).
        # Detach the distance and carry d log p(dist; extinction)
        # = 1/extinction - dist on the score instead — the same
        # decomposition the hand-derived backward uses
        # (kernels/spectral_backward.py), unbiased through the event wheel
        # AND the escape boundary. Forward values are unchanged.
        #
        # Majorant mode: the local sampling rate is
        # extinction * m with m a DETACHED sampling-distribution choice
        # (any valid bound gives the same expectation, so m carries no
        # physical gradient). An uncapped flight contributes the collision
        # density log(rate) - rate*dist; a capped flight is a pure advance
        # whose likelihood is the survival probability exp(-rate*cap) —
        # the log-survival term -rate*dist (dist == cap after the min).
        if maj is not None:
            rate = ctx.extinction * jax.lax.stop_gradient(maj)
            logp = (jnp.where(capped, 0.0, jnp.log(rate))
                    - rate * jax.lax.stop_gradient(dist))
        else:
            logp = jnp.log(ctx.extinction) - ctx.extinction * jax.lax.stop_gradient(dist)
        score = score * jnp.exp(logp - jax.lax.stop_gradient(logp))
        dist = jax.lax.stop_gradient(dist)
    px = p.px + dist * p.dx
    py = p.py + dist * p.dy
    pz = p.pz + dist * p.dz

    oob = (
        (px > 1.0) | (px < 0.0) | (py > 1.0) | (py < 0.0) | (pz > 1.0) | (pz < 0.0)
    )

    # material lookup: volume density -> 2D TF at (wavelength_t, density)
    # (sample_volume_fn overrides the sampler, e.g. the slab-sharded
    # distributed gather in parallel/slab.py)
    t = (p.wavelength - 400.0) / 300.0
    sample_volume = sample_volume_fn or interp.sample_volume
    dens = sample_volume(ctx.density, px, py, pz, volume_filter)
    # fused TF+light table ((257,257,18), pack_tex2d_with_tex1d): the light
    # spectrum shares the TF's x coordinate, so one gather returns both
    light_raw = None
    tf_extras = None
    if ctx.material_tf.shape[-1] == 18:
        if collect:
            # the packed-adjoint backward reuses the gathered TF rows for
            # slopes/scatters — no second gather (kernels/spectral_backward)
            mat, light_raw, tf_extras = interp.sample_tex2d_fused1d(
                ctx.material_tf, t, dens, return_extras=True
            )
        else:
            mat, light_raw = interp.sample_tex2d_fused1d(ctx.material_tf, t, dens)
    else:
        mat = interp.sample_tex2d(ctx.material_tf, t, dens)
    albedo = mat[..., 0]
    alpha = mat[..., 1]
    g = mat[..., 2] * 2.0 - 1.0

    if maj is not None:
        # delta-tracking acceptance against the local majorant: real-event
        # probability alpha/m (<= 1 by construction of the table); the wheel
        # then splits the real event into scatter/absorb like the reference.
        # Under diff, alpha stays differentiable (the TF->density chain) and
        # m is detached — the acceptance score alpha/m has the same
        # d log P / d alpha = 1/alpha form as the exact wheel. NOTE the
        # table must remain a true bound for the CURRENT params: inverse
        # loops that raise density past the build-time bound should rebuild
        # the table (or build with safety headroom, ops/majorant safety=).
        p_real = jnp.minimum(alpha / jax.lax.stop_gradient(maj), 1.0)
        p_scatter = jnp.where(p.bounces >= ctx.max_bounces, 0.0, p_real * albedo)
        p_absorb = p_real - p_scatter
        p_null = 1.0 - p_real
    else:
        p_null = 1.0 - alpha
        p_scatter = jnp.where(p.bounces >= ctx.max_bounces, 0.0, alpha * albedo)
        p_absorb = 1.0 - p_null - p_scatter

    rng, wheel = sampling.draw(rng, all_mask)

    event = ~oob if maj is None else (~oob) & (~capped)
    absorb = event & (wheel < p_absorb)
    scatter = event & (~absorb) & (wheel < p_absorb + p_scatter)
    null = event & (~absorb) & (~scatter)
    respawn = oob | absorb

    # -- radiance deposit (incremental one-hot mean over all bins) ---------
    if ctx.environment is not None:
        escape = _sample_environment(ctx, p.dx, p.dy, p.dz, p.wavelength)
    else:
        escape = _sample_light(ctx, p.dx, p.dy, p.dz, p.wavelength, raw=light_raw)
    emitted = jnp.where(oob, escape, 0.0)
    if diff:
        # terminal deposit carries the path's accumulated score weight
        # (absorb deposits 0, so only escape paths contribute gradient)
        emitted = emitted * score
    samples = p.samples + respawn.astype(jnp.int32)
    one_hot = (
        jax.lax.broadcasted_iota(jnp.int32, (n_bins,) + p.bin.shape, 0) == p.bin[None]
    )
    target = jnp.where(one_hot, emitted[None], 0.0)
    denom = jnp.maximum(samples, 1).astype(jnp.float32)[None]
    radiance = jnp.where(
        respawn[None], p.radiance + (target - p.radiance) / denom, p.radiance
    )
    # the reference's PhotonSpectral carries transmittance[12] but nothing
    # ever writes a value != 1.0 (reset sets 1.0, no event mutates it, and
    # the escape deposit deliberately skips it — wgsl:146 comment); the
    # respawn re-write is therefore value-identical to a pass-through, and
    # passing it through lets XLA alias the (B,S,H,W) array instead of
    # re-materializing ~100 MB/step of provably-constant state
    transmittance = p.transmittance

    # -- respawn (masked draws: disk2 + square2 + lambda1) -----------------
    rng, new = _respawn(rng, respawn, sx, sy, ctx, n_bins)

    # -- scatter (masked draws: sphere2 [+ hg-cos where |g| >= EPS]) -------
    rng, (hx, hy, hz) = sampling.draw_hg(rng, scatter, g, p.dx, p.dy, p.dz)

    if diff:
        # continuing events multiply the carried weight; respawned lanes
        # restart at 1 (their terminal weight was just consumed above)
        score = score * _surrogate(p_null, null) * _surrogate(p_scatter, scatter)
        score = jnp.where(respawn, 1.0, score)

    px = jnp.where(respawn, new["px"], px)
    py = jnp.where(respawn, new["py"], py)
    pz = jnp.where(respawn, new["pz"], pz)
    dx = jnp.where(respawn, new["dx"], jnp.where(scatter, hx, p.dx))
    dy = jnp.where(respawn, new["dy"], jnp.where(scatter, hy, p.dy))
    dz = jnp.where(respawn, new["dz"], jnp.where(scatter, hz, p.dz))
    bounces = jnp.where(
        respawn, 0, p.bounces + scatter.astype(jnp.int32)
    )
    lam = jnp.where(respawn, new["wavelength"], p.wavelength)
    bin_ = jnp.where(respawn, new["bin"], p.bin)

    out_state = SpectralState(
        px=px, py=py, pz=pz, dx=dx, dy=dy, dz=dz,
        bounces=bounces, samples=samples, bin=bin_, wavelength=lam,
        radiance=radiance, transmittance=transmittance,
    )
    if collect:
        internals = dict(
            dist=dist,
            sample_pos=(p.px + dist * p.dx, p.py + dist * p.dy, p.pz + dist * p.dz),
            pre_dir=(p.dx, p.dy, p.dz),
            pre_wavelength=p.wavelength,
            pre_bin=p.bin,
            dens=dens, albedo=albedo, alpha=alpha, g=g,
            null=null, scatter=scatter, absorb=absorb, oob=oob,
            respawn=respawn, emitted=emitted, samples_after=samples,
            hg_cos=hx * p.dx + hy * p.dy + hz * p.dz,
            tf_extras=tf_extras,
        )
        return out_state, rng, score, internals
    return out_state, rng, score


def radiance_to_rgb(radiance, bin_xyz):
    """Binned radiance -> (H,W,3) linear sRGB (wgsl:304-326).

    Accepts (B,H,W) or (B,S,H,W); stream estimates average equally (the
    XYZ map is linear, so mean-then-convert == convert-then-mean)."""
    if radiance.ndim == 4:
        radiance = jnp.mean(radiance, axis=1)
    xyz = jnp.einsum("bhw,cb->hwc", radiance, bin_xyz,
                     precision=jax.lax.Precision.HIGHEST)
    from vpt_tpu.ops.spectral import XYZ_TO_SRGB_KERNEL

    return jnp.matmul(xyz, jnp.asarray(XYZ_TO_SRGB_KERNEL).T,
                      precision=jax.lax.Precision.HIGHEST)


@functools.partial(
    jax.jit,
    static_argnames=("steps", "n_bins", "volume_filter"),
    donate_argnames=("state",),
)
def render(
    state: SpectralState,
    ctx: SpectralCtx,
    steps: int,
    n_bins: int,
    volume_filter: str = "linear",
):
    """One render dispatch: `steps` Woodcock iterations + display conversion.

    Returns (new_state, (H, W, 3) linear-RGB image). State is donated: the
    accumulation buffers live on device across dispatches (the reference's
    persistent photon storage buffer).
    """
    resolution = state.px.shape[-1]
    streams = state.px.shape[0] if state.px.ndim == 3 else 1
    ix, iy, seed_iy = _pixel_grid(resolution, streams)
    sx, sy = geometry.screen_position(ix, iy, 1.0 / resolution)
    rng = sampling.seed_state(ix, seed_iy, ctx.seed_bits)

    def body(_, carry):
        p, r = carry
        p, r, _ = _render_body(p, r, None, sx, sy, ctx, n_bins, volume_filter, diff=False)
        return (p, r)

    state, rng = jax.lax.fori_loop(0, steps, body, (state, rng))
    image = radiance_to_rgb(state.radiance, ctx.bin_xyz)
    return state, image


@functools.partial(
    jax.jit,
    static_argnames=("steps", "n_bins", "volume_filter"),
    donate_argnames=("state",),
)
def render_many(
    state: SpectralState,
    ctx: SpectralCtx,
    seeds: jax.Array,
    steps: int,
    n_bins: int,
    volume_filter: str = "linear",
):
    """K render dispatches in one device program: lax.scan over per-dispatch
    frame seeds (the replacement for the reference's
    one-rAF-tick-one-dispatch loop — amortizes all host/dispatch overhead).

    ``seeds``: (K,) uint32. Bit-identical to K sequential ``render`` calls
    with those seeds. Returns (state, final HDR image).
    """
    resolution = state.px.shape[-1]
    streams = state.px.shape[0] if state.px.ndim == 3 else 1
    ix, iy, seed_iy = _pixel_grid(resolution, streams)
    sx, sy = geometry.screen_position(ix, iy, 1.0 / resolution)

    def dispatch(p, seed_bits):
        rng = sampling.seed_state(ix, seed_iy, seed_bits)

        def body(_, carry):
            q, r = carry
            q, r, _ = _render_body(q, r, None, sx, sy, ctx,
                                   n_bins, volume_filter, diff=False)
            return (q, r)

        p, _ = jax.lax.fori_loop(0, steps, body, (p, rng))
        return p, None

    state, _ = jax.lax.scan(dispatch, state, seeds)
    image = radiance_to_rgb(state.radiance, ctx.bin_xyz)
    return state, image


def render_diff(state: SpectralState, score, ctx: SpectralCtx, steps: int,
                n_bins: int, volume_filter: str = "linear"):
    """Differentiable render dispatch (un-jitted building block).

    Identical forward semantics to ``render`` (same RNG consumption, same
    images bit-for-bit), but the steps loop is a reverse-differentiable
    ``lax.scan`` threading per-lane REINFORCE score weights, so gradients of
    the output image flow to density / material TF / light spectrum /
    extinction. ``score``: (H, W) carried weights (ones after a full reset).

    Returns (state, score, image).
    """
    resolution = state.px.shape[-1]
    streams = state.px.shape[0] if state.px.ndim == 3 else 1
    ix, iy, seed_iy = _pixel_grid(resolution, streams)
    sx, sy = geometry.screen_position(ix, iy, 1.0 / resolution)
    rng = sampling.seed_state(ix, seed_iy, ctx.seed_bits)

    def body(carry, _):
        p, r, s = carry
        p, r, s = _render_body(p, r, s, sx, sy, ctx, n_bins, volume_filter, diff=True)
        return (p, r, s), None

    (state, rng, score), _ = jax.lax.scan(
        body, (state, rng, score), None, length=steps
    )
    image = radiance_to_rgb(state.radiance, ctx.bin_xyz)
    return state, score, image


def render_sequence_diff(ctx_seeds, init_state, ctx: SpectralCtx, steps: int,
                         n_bins: int, volume_filter: str = "linear"):
    """Differentiable multi-dispatch accumulation: scan ``render_diff`` over
    per-dispatch seeds (rematerialized per dispatch to bound memory).

    ``ctx_seeds``: (K,) uint32 frame seeds. Returns the final HDR image.
    """
    score0 = jnp.ones_like(init_state.px)

    @jax.checkpoint
    def body(carry, seed_bits):
        state, score = carry
        c = ctx._replace(seed_bits=seed_bits)
        state, score, image = render_diff(state, score, c, steps, n_bins, volume_filter)
        return (state, score), image

    (state, _), images = jax.lax.scan(body, (init_state, score0), ctx_seeds)
    return images[-1]


# --------------------------------------------------------------------------
# Renderer class (factory-facing)
# --------------------------------------------------------------------------
@register_renderer("mcm-spectral")
class MCMSpectralRenderer:
    """Progressive spectral MCM renderer bound to scene resources."""

    def __init__(
        self,
        volume,
        material_tf: MaterialTF | None = None,
        light: LightConfig | None = None,
        spectrum: SpectrumConfig | None = None,
        config: MCMSpectralConfig | None = None,
        resolution: int = 512,
        pack_tables: bool | set = True,
        streams: int = 1,
        environment=None,
        majorant_blocks: int | None = None,
        mesh=None,
        compaction: bool = False,
    ):
        from vpt_tpu.ops.spectral import bin_coefficients

        self.volume = volume
        self.material_tf = material_tf or MaterialTF.constant(0.5, 0.5)
        self.light = light or LightConfig()
        self.spectrum = spectrum or SpectrumConfig()
        self.config = config or MCMSpectralConfig()
        self.resolution = resolution
        # S independent photon streams per pixel: same converged image,
        # ~2-3x throughput (amortizes the per-gather-op cost); S=1 is the
        # reference-exact layout
        self.streams = streams

        bx, by, bz = bin_coefficients(np.array(self.spectrum.boundaries))
        self._bin_xyz = np.stack([bx, by, bz]).astype(np.float32)

        # Scene resources are uploaded once and stay device-resident across
        # dispatches (unlike the reference, which re-writes the TF textures
        # every frame — cheap over PCIe, ruinous over anything slower).
        # Renderer configs are immutable; changing resources = new renderer.
        # pack_tables precomputes single-gather corner tables (8x/4x memory
        # for ~3x dispatch speed); disable to keep the raw parameterization
        # (e.g. when differentiating w.r.t. the tables). It accepts a bool
        # or a subset of {"density", "material_tf", "light_spectrum"} —
        # e.g. huge volumes whose 8x packed table would not fit the device
        # can keep
        # the raw grid while the TF/light still pack.
        density = self.volume.density
        mtf = self.material_tf.table
        light_spectrum = self.light.spectrum_array()
        if pack_tables is True:
            pack_tables = {"density", "material_tf", "light_spectrum"}
        elif pack_tables is False:
            pack_tables = set()
        if self.volume.filter in ("linear", "quasicubic"):
            # packed tables are stored flat (interp.PackedVolume)
            if "density" in pack_tables:
                density = interp.pack_volume_auto(density, "full")
            elif "density_xy" in pack_tables:
                # 4x-memory half packing: 2 gathers/step instead of 8 —
                # the mode for volumes whose 8x table exceeds device memory
                density = interp.pack_volume_auto(density, "xy")
            if "material_tf" in pack_tables and "light_spectrum" in pack_tables:
                # fused (257,257,18) table: the light's packed pair rides the
                # TF gather (shared x coordinate) — the per-step light lookup
                # disappears entirely. ctx.light_spectrum keeps the packed 1D
                # table for any standalone use.
                mtf = interp.pack_tex2d_with_tex1d(mtf, light_spectrum)
                light_spectrum = interp.pack_tex1d_corners(light_spectrum)
            elif "material_tf" in pack_tables:
                mtf = interp.pack_tex2d_corners(mtf)
            elif "light_spectrum" in pack_tables:
                light_spectrum = interp.pack_tex1d_corners(light_spectrum)
        # optional super-voxel majorant grid (ops/majorant): built from the
        # RAW density + TF before any packing; statistically exact mode that
        # trades per-sample reference parity for far fewer steps per path
        # (the big-volume / sparse-scene accelerator, BASELINE config 5)
        maj = None
        if majorant_blocks is not None:
            from vpt_tpu.ops.majorant import build_majorant_grid

            maj = jnp.asarray(
                build_majorant_grid(
                    self.volume.density, self.material_tf.table,
                    self.config.extinction, block=majorant_blocks,
                )
            )
        env = None
        if environment is not None:
            env = np.asarray(environment, np.float32)
            if "material_tf" in pack_tables:  # same packing policy as the TF
                env = interp.pack_tex2d_corners(env)
            env = jnp.asarray(env)
        cfg = self.config
        self._static_ctx = dict(
            environment=env,
            majorant=maj,
            extinction=jnp.float32(cfg.extinction),
            blur=jnp.float32(cfg.blur),
            max_bounces=jnp.int32(cfg.bounces),
            light_direction=jnp.asarray(self.light.direction, jnp.float32),
            density=(density if isinstance(density, interp.PackedVolume)
                     else jnp.asarray(density)),
            material_tf=jnp.asarray(mtf),
            light_spectrum=jnp.asarray(light_spectrum),
            boundaries=jnp.asarray(self.spectrum.boundaries, jnp.float32),
            bin_xyz=jnp.asarray(self._bin_xyz),
        )
        # hit-lane compaction (models/mcm_spectral_compact.py): march lanes
        # only for pixels whose ray bundle can hit the cube; miss pixels
        # take the closed-form expectation of the same estimator. Opt-in:
        # changes the Mpaths/s accounting (miss-lane churn disappears).
        self.compaction = compaction
        if compaction:
            # ValueError (not assert): these are user-configuration errors
            # and must survive python -O
            if self.config.blur != 0.0:
                raise ValueError(
                    "compaction requires blur=0 (depth of field widens the "
                    "ray bundle beyond the per-pixel pyramid test)")
            if mesh is not None:
                raise ValueError("compaction is a single-device mode")
            self._light_raw = np.asarray(self.light.spectrum_array(),
                                         np.float32)
            # raw (unpacked) env image for the closed-form miss quadrature
            self._env_raw = (None if environment is None
                             else np.asarray(environment, np.float32))
            self._compact_cache = {}

        # mesh-aware mode: scene resources replicate across the "rays" mesh
        # and reset() returns row-sharded state, so render/render_many run
        # multi-device through the same public API (the reference's single
        # L3 context serving any device, WebGPURenderingContext.js:117-251)
        self.mesh = mesh
        if mesh is not None:
            from vpt_tpu.parallel.mesh import replicated

            self._static_ctx = {
                k: (v if v is None else jax.device_put(v, replicated(mesh)))
                for k, v in self._static_ctx.items()
            }

    def ctx(self, camera, seed: int) -> SpectralCtx:
        """Build the dynamic context for one dispatch.

        ``seed`` is a deterministic per-dispatch integer (the reference used
        Math.random(); we hash the dispatch index for reproducibility)."""
        seed_bits = np.uint32(seed) if isinstance(seed, (int, np.integer)) else np.float32(seed).view(np.uint32)
        inv_mvp = jnp.asarray(camera.inverse_mvp())
        seed_bits = jnp.uint32(seed_bits)
        if self.mesh is not None:
            from vpt_tpu.parallel.mesh import replicated

            inv_mvp = jax.device_put(inv_mvp, replicated(self.mesh))
            seed_bits = jax.device_put(seed_bits, replicated(self.mesh))
        return SpectralCtx(
            inv_mvp=inv_mvp,
            seed_bits=seed_bits,
            **self._static_ctx,
        )

    def shard_state(self, state: SpectralState) -> SpectralState:
        """Place accumulation state on the renderer's mesh (no-op without
        one). Used by reset() and by checkpoint restore (session.py)."""
        if self.mesh is None:
            return state
        from vpt_tpu.parallel.mesh import shard_spectral_state

        return shard_spectral_state(state, self.mesh)

    # bound on _compact_tables' per-pose cache: an orbit/animation renders
    # many poses and must not grow host memory without bound
    COMPACT_CACHE_POSES = 8

    def _compact_tables(self, camera):
        """Per-camera-pose lane tables + closed-form miss image. LRU-cached
        over the last COMPACT_CACHE_POSES poses; lane-row counts are
        bucketed (build_lane_tables row_bucket) so consecutive orbit poses
        reuse the compiled render program."""
        from vpt_tpu.models import mcm_spectral_compact as C

        inv_mvp = camera.inverse_mvp()
        key = inv_mvp.tobytes()
        if key not in self._compact_cache:
            hit = C.hit_pixel_mask(inv_mvp, self.resolution)
            t = C.build_lane_tables(hit, self.resolution, self.streams)
            if self._env_raw is not None:
                miss = C.analytic_miss_radiance_env(
                    inv_mvp, self.resolution, self._env_raw,
                    self.spectrum.boundaries, self.spectrum.n_bins)
            else:
                miss = C.analytic_miss_radiance(
                    inv_mvp, self.resolution, self._light_raw,
                    self.light.direction, self.spectrum.boundaries,
                    self.spectrum.n_bins)
            while len(self._compact_cache) >= self.COMPACT_CACHE_POSES:
                self._compact_cache.pop(next(iter(self._compact_cache)))
            self._compact_cache[key] = dict(
                hit=jnp.asarray(hit),
                miss=jnp.asarray(miss),
                lane_ix=jnp.asarray(t["lane_ix"]),
                lane_iy=jnp.asarray(t["lane_iy"]),
                lane_seed_iy=jnp.asarray(t["lane_seed_iy"]),
                lane_pixel=jnp.asarray(t["lane_pixel"]),
                n_hit=t["n_hit"],
            )
        else:
            # LRU: re-append on hit so the eviction order is least-recent
            self._compact_cache[key] = self._compact_cache.pop(key)
        return self._compact_cache[key]

    def reset(self, camera, seed: int = 0) -> SpectralState:
        if self.compaction:
            from vpt_tpu.models import mcm_spectral_compact as C

            t = self._compact_tables(camera)
            return C.compact_reset(
                self.ctx(camera, seed), t["lane_ix"], t["lane_iy"],
                t["lane_seed_iy"], self.spectrum.n_bins, self.resolution)
        return self.shard_state(
            full_reset(self.ctx(camera, seed), self.resolution,
                       self.spectrum.n_bins, streams=self.streams)
        )

    def render(self, state: SpectralState, camera, seed: int):
        if self.compaction:
            return self.render_many(state, camera, [seed])
        return render(
            state,
            self.ctx(camera, seed),
            steps=self.config.steps,
            n_bins=self.spectrum.n_bins,
            volume_filter=self.volume.filter,
        )

    def render_many(self, state: SpectralState, camera, seeds):
        """K dispatches in one device program (amortized host overhead)."""
        import numpy as np

        seeds = jnp.asarray(np.asarray(seeds, np.uint32))
        if self.compaction:
            from vpt_tpu.models import mcm_spectral_compact as C

            t = self._compact_tables(camera)
            ctx = self.ctx(camera, int(np.asarray(seeds)[0]))
            state = C.render_compact_many(
                state, ctx, seeds, t["lane_ix"], t["lane_iy"],
                t["lane_seed_iy"], steps=self.config.steps,
                n_bins=self.spectrum.n_bins, resolution=self.resolution,
                volume_filter=self.volume.filter)
            image = C.compact_image(
                state, t["lane_pixel"], t["hit"], t["miss"], ctx.bin_xyz,
                self.resolution, self.streams)
            return state, image
        return render_many(
            state,
            self.ctx(camera, int(np.asarray(seeds)[0])),
            seeds,
            steps=self.config.steps,
            n_bins=self.spectrum.n_bins,
            volume_filter=self.volume.filter,
        )
