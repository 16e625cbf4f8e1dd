"""Hit-lane compaction for the spectral MCM renderer (opt-in mode).

At the reference's default pose (camera z=2, fovy=1) only ~1/3 of pixels
intersect the unit volume cube; the lockstep megakernel still marches one
lane per pixel (x streams), so ~2/3 of every dispatch's gathers and RNG
work Monte-Carlo-estimates pixels whose value is available in closed
form: a camera ray that misses the cube deposits escape(lambda, dir)
every sample and never touches the volume
(/root/reference/src/wgsl/renderers/MCMSpectralComputeRenderer.wgsl:142-150
runs exactly this trivial loop for silhouette-exterior threads — it just
cannot drop them, because its threads ARE the pixel grid).

Here the lane set is ours to choose, so compaction:

1. classifies pixels host-side with a CONSERVATIVE pixel-pyramid vs cube
   separating-plane test (a pixel is "miss" only if its whole AA-jitter
   ray bundle provably misses; uncertain pixels stay "hit");
2. marches lanes for hit pixels only, packed into an (M, resolution)
   array so every shape-derived constant downstream (AA jitter scale,
   seeding) matches the full kernel; each lane's RNG chain seeds from its
   pixel's (ix, iy + s*resolution) exactly like the full kernel, so a
   hit pixel's estimate is the full kernel's estimate for the same seeds
   (same draws, same event sequences — bit-identical sample counters in
   every mode). Deposit values are bit-identical for the directional-
   light path; under an ENVIRONMENT map a handful of near-polar escape
   deposits can differ by ~1e-3: the equirect v goes through arcsin
   (unbounded derivative at the poles), which amplifies the ulp-level
   direction-rounding differences between the two differently-shaped
   XLA programs (ARCHITECTURE.md "the env-mode parity caveat");
3. replaces miss pixels with the closed-form expectation of the SAME
   estimator: per-bin mean radiance E[1{bin(l)=b} * escape(l, dir)]
   = 5 * I_b * mean_gain(pixel), with I_b the per-bin integral of the
   interpolated light spectrum (exact quadrature of the kernel's own
   lookup arithmetic) and mean_gain the subpixel-averaged directional
   factor max(dot(dir, light_dir), 0).

Restrictions (raised as ValueError): blur == 0 (DoF widens the ray bundle
beyond the pixel pyramid), no mesh. Environment maps ARE supported
(round 5): the miss closed form becomes the per-bin band fraction times
the subpixel-averaged equirect lookup (analytic_miss_radiance_env);
RGB MCM gets the same machinery in models/mcm_compact.py.

Benchmark: tools/compact_bench.py (default pose, 512^2 x 4 streams,
128^3); not yet measured on the GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from vpt_tpu.models import mcm_spectral as M
from vpt_tpu.ops import geometry, sampling

EPS = 1e-5


# --------------------------------------------------------------------------
# Host-side classification + closed forms (numpy, once per camera pose)
# --------------------------------------------------------------------------
def _unproject_np(inv_mvp, x, y, z):
    """Host replica of geometry._apply_homogeneous (row-major, w-divide)."""
    m = np.asarray(inv_mvp, np.float64)
    rx = m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3]
    ry = m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3]
    rz = m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3]
    rw = m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3]
    return np.stack([rx / rw, ry / rw, rz / rw], axis=-1)


def hit_pixel_mask(inv_mvp, resolution: int) -> np.ndarray:
    """(H, W) bool: True where the pixel's ray bundle MAY hit the cube.

    Conservative separating-plane test of the pixel pyramid (apex = the
    pixel center's near-plane point — the blur=0 ray origin,
    geometry.unproject_rand — through the pixel's far-plane quad, the
    AA-jitter footprint) against the unit cube: classified miss only if
    all 8 cube corners lie strictly outside one of the 4 side planes.
    False negatives are impossible; false "hit" pixels just march
    normally and deposit the reference miss path.
    """
    res = resolution
    # NDC corner grids (pixel centers at ((i+0.5)/res - 0.5) * (2, -2))
    cx = (np.arange(res + 1) / res - 0.5) * 2.0
    cy = (np.arange(res + 1) / res - 0.5) * -2.0
    sx = ((np.arange(res) + 0.5) / res - 0.5) * 2.0
    sy = ((np.arange(res) + 0.5) / res - 0.5) * -2.0

    # far-plane corner grid (res+1, res+1, 3), indexed [ix, iy]
    FX, FY = np.meshgrid(cx, cy, indexing="ij")
    far = _unproject_np(inv_mvp, FX, FY, 1.0)
    # per-pixel apex (near-plane center) and far center, indexed [ix, iy]
    AX, AY = np.meshgrid(sx, sy, indexing="ij")
    apex = _unproject_np(inv_mvp, AX, AY, -1.0)       # (res, res, 3)
    far_c = _unproject_np(inv_mvp, AX, AY, 1.0)

    c00 = far[:-1, :-1] - apex
    c10 = far[1:, :-1] - apex
    c11 = far[1:, 1:] - apex
    c01 = far[:-1, 1:] - apex
    center = far_c - apex

    corners = np.stack(np.meshgrid([0.0, 1.0], [0.0, 1.0], [0.0, 1.0],
                                   indexing="ij"), axis=-1).reshape(8, 3)

    miss = np.zeros((res, res), bool)
    for e0, e1 in ((c00, c10), (c10, c11), (c11, c01), (c01, c00)):
        n = np.cross(e0, e1)                           # (res, res, 3)
        # orient inward (positive toward the pixel's center ray)
        sgn = np.sign(np.einsum("xyk,xyk->xy", n, center))
        n = n * np.where(sgn == 0, 1.0, sgn)[..., None]
        # signed distance of each cube corner from each pixel's plane
        d = (np.einsum("xyk,ck->xyc", n, corners)
             - np.einsum("xyk,xyk->xy", n, apex)[..., None])
        miss |= (d < 0).all(axis=-1)
    # mask indexed [ix, iy] -> transpose to (H=iy, W=ix)
    return ~miss.T


def _light_raw_np(light_256, t):
    """Host replica of the fused-table light interpolation
    (interp.pack_tex1d_corners + the fx lerp in sample_tex2d_fused1d)."""
    lt = np.asarray(light_256, np.float64)
    N = lt.shape[0]  # 256
    s = np.asarray(t, np.float64) * N - 0.5
    i0 = np.floor(s)
    f = s - i0
    b = np.clip(i0.astype(np.int64) + 1, 0, N)
    p = np.pad(lt, 1, mode="edge")  # p[k] = lt[clip(k-1, 0, N-1)]
    return p[b] + (p[b + 1] - p[b]) * f


def bin_light_integrals(light_256, boundaries, n_bins: int,
                        samples: int = 200_000) -> np.ndarray:
    """I_b = E_{l~U(lo,hi)}[1{bin(l)=b} * raw(l)] per bin (the expectation
    of the kernel's one-hot deposit's spectrum factor), by quadrature of
    the kernel's own lookup arithmetic (t=(l-400)/300, 256-texel linear,
    clamp-to-edge)."""
    bounds = np.asarray(boundaries, np.float64)
    lo, hi = bounds[0], bounds[n_bins]
    lam = lo + (np.arange(samples) + 0.5) / samples * (hi - lo)
    raw = _light_raw_np(light_256, (lam - 400.0) / 300.0)
    b = np.zeros(samples, np.int64)
    for i in range(1, n_bins):
        b += (lam >= bounds[i]).astype(np.int64)
    out = np.zeros(n_bins, np.float64)
    np.add.at(out, b, raw)
    return out / samples


def mean_gain_image(inv_mvp, resolution: int, light_direction,
                    k: int = 8) -> np.ndarray:
    """(H, W) subpixel-averaged directional factor E[max(dot(dir, ldn), 0)]
    over the AA-jitter square (k x k midpoint quadrature); all-ones for an
    isotropic light (|light_direction| < EPS)."""
    ld = np.asarray(light_direction, np.float64)
    norm = float(np.sqrt((ld * ld).sum()))
    if norm < EPS:
        return np.ones((resolution, resolution), np.float64)
    ldn = ld / norm
    res = resolution
    sx = ((np.arange(res) + 0.5) / res - 0.5) * 2.0
    sy = ((np.arange(res) + 0.5) / res - 0.5) * -2.0
    AX, AY = np.meshgrid(sx, sy, indexing="xy")  # (H=iy rows, W=ix cols)
    apex = _unproject_np(inv_mvp, AX, AY, -1.0)  # (H, W, 3)
    acc = np.zeros((res, res), np.float64)
    inv_res = 1.0 / res
    for a in range(k):
        for b in range(k):
            jx = ((a + 0.5) / k * 2.0 - 1.0) * inv_res
            jy = ((b + 0.5) / k * 2.0 - 1.0) * inv_res
            far = _unproject_np(inv_mvp, AX + jx, AY + jy, 1.0)
            d = far - apex
            d /= np.linalg.norm(d, axis=-1, keepdims=True)
            acc += np.maximum(d @ ldn, 0.0)
    return acc / (k * k)


def analytic_miss_radiance(inv_mvp, resolution, light_256, light_direction,
                           boundaries, n_bins) -> np.ndarray:
    """(B, H, W) f32: the converged per-bin radiance means of miss pixels
    (5 * I_b * mean_gain — the exact expectation of the kernel's one-hot
    incremental-mean estimator for rays that never enter the cube)."""
    I = bin_light_integrals(light_256, boundaries, n_bins)    # (B,)
    g = mean_gain_image(inv_mvp, resolution, light_direction)  # (H, W)
    return (5.0 * I[:, None, None] * g[None]).astype(np.float32)


# --------------------------------------------------------------------------
# Environment-map closed form: a miss ray under an env map
# deposits escape = 2.7 * env_channel(band(lambda))(dir) every sample
# (mcm_spectral._sample_environment). lambda and the AA jitter are
# independent uniforms, so the per-bin mean factorizes:
#   E[1{bin=b} * escape] = 2.7 * sum_c P(lambda in bin_b AND band_c)
#                              * E_jitter[env_c(dir)]
# with the three bands of the kernel's wavelength->channel selection
# (lam < 500 -> B(2), < 600 -> G(1), else R(0)) and E_jitter the
# subpixel-averaged equirect bilinear lookup — the same quadrature
# machinery as mean_gain_image, per channel.
# --------------------------------------------------------------------------
def band_bin_fractions(boundaries, n_bins: int) -> np.ndarray:
    """(B, 3) P(lambda in bin b AND wavelength band of channel c), for
    lambda ~ U(boundaries[0], boundaries[n_bins]). Bands follow
    _sample_environment: channel 2 below 500 nm, 1 in [500, 600), 0 above."""
    bounds = np.asarray(boundaries, np.float64)
    lo, hi = bounds[0], bounds[n_bins]
    total = hi - lo
    bands = {2: (-np.inf, 500.0), 1: (500.0, 600.0), 0: (600.0, np.inf)}
    out = np.zeros((n_bins, 3), np.float64)
    for b in range(n_bins):
        b_lo, b_hi = bounds[b], bounds[b + 1]
        for c, (c_lo, c_hi) in bands.items():
            out[b, c] = max(0.0, min(b_hi, c_hi) - max(b_lo, c_lo)) / total
    return out


def _bilinear_np(tex, u, v):
    """Host replica of interp.sample_tex2d on a raw (H, W, C) texture
    (texel centers at (i+0.5)/N, clamp-to-edge)."""
    t = np.asarray(tex, np.float64)
    H, W, _ = t.shape

    def coords(x, n):
        s = np.asarray(x, np.float64) * n - 0.5
        i0 = np.floor(s)
        f = s - i0
        lo = np.clip(i0.astype(np.int64), 0, n - 1)
        hi = np.clip(i0.astype(np.int64) + 1, 0, n - 1)
        return lo, hi, f

    x0, x1, fx = coords(u, W)
    y0, y1, fy = coords(v, H)
    c00 = t[y0, x0]
    c01 = t[y0, x1]
    c10 = t[y1, x0]
    c11 = t[y1, x1]
    c0 = c00 + (c01 - c00) * fx[..., None]
    c1 = c10 + (c11 - c10) * fx[..., None]
    return c0 + (c1 - c0) * fy[..., None]


def mean_env_image(inv_mvp, resolution: int, env_raw, k: int = 8) -> np.ndarray:
    """(H, W, 3) subpixel-averaged equirect environment lookup
    E_jitter[env(dir)] — the kernel's own addressing (equirect with the
    reference's y quirk, _sample_environment / mcm.sample_environment),
    k x k midpoint quadrature over the AA-jitter square."""
    res = resolution
    sx = ((np.arange(res) + 0.5) / res - 0.5) * 2.0
    sy = ((np.arange(res) + 0.5) / res - 0.5) * -2.0
    AX, AY = np.meshgrid(sx, sy, indexing="xy")  # (H=iy rows, W=ix cols)
    apex = _unproject_np(inv_mvp, AX, AY, -1.0)  # (H, W, 3)
    acc = np.zeros((res, res, 3), np.float64)
    inv_res = 1.0 / res
    inv_pi = 1.0 / np.pi
    for a in range(k):
        for b in range(k):
            jx = ((a + 0.5) / k * 2.0 - 1.0) * inv_res
            jy = ((b + 0.5) / k * 2.0 - 1.0) * inv_res
            far = _unproject_np(inv_mvp, AX + jx, AY + jy, 1.0)
            d = far - apex
            d /= np.linalg.norm(d, axis=-1, keepdims=True)
            u = np.arctan2(d[..., 0], -d[..., 2]) * inv_pi * 0.5 + 0.5
            v = np.arcsin(np.clip(-d[..., 1], -1.0, 1.0)) * 2.0 * inv_pi * 0.5 + 0.5
            acc += _bilinear_np(env_raw, u, v)
    return acc / (k * k)


def analytic_miss_radiance_env(inv_mvp, resolution, env_raw, boundaries,
                               n_bins) -> np.ndarray:
    """(B, H, W) f32 converged per-bin radiance means of miss pixels under
    an environment map: 2.7 * sum_c frac[b, c] * mean_env[:, :, c]."""
    frac = band_bin_fractions(boundaries, n_bins)            # (B, 3)
    env = mean_env_image(inv_mvp, resolution, env_raw)       # (H, W, 3)
    return (2.7 * np.einsum("bc,hwc->bhw", frac, env)).astype(np.float32)


# --------------------------------------------------------------------------
# Lane tables (host, once per camera pose)
# --------------------------------------------------------------------------
def build_lane_tables(hit: np.ndarray, resolution: int, streams: int,
                      row_bucket: int = 64):
    """Pack hit pixels (x streams) into (M, resolution) lane coordinate
    arrays + the flat scatter-back index (padding lanes -> the dump row
    n_pixels).

    ``row_bucket``: round the lane-row count M up to a multiple of this, so
    nearby camera poses (whose hit counts differ slightly) produce the SAME
    lane-array shape and reuse the compiled render program instead of
    re-jitting per pose. Padding lanes are harmless — they
    march pixel (0, 0)'s chain but scatter to the dump row."""
    iy, ix = np.nonzero(hit)
    n_hit = ix.size
    n_pixels = resolution * resolution
    L = n_hit * streams
    M = max((L + resolution - 1) // resolution, 1)
    if row_bucket > 1:
        M = -(-M // row_bucket) * row_bucket
    pad = M * resolution - L

    s = np.repeat(np.arange(streams, dtype=np.uint32), n_hit)
    lane_ix = np.tile(ix.astype(np.uint32), streams)
    lane_iy = np.tile(iy.astype(np.uint32), streams)
    lane_seed_iy = lane_iy + s * np.uint32(resolution)
    lane_pixel = (lane_iy.astype(np.int64) * resolution
                  + lane_ix).astype(np.int32)

    def padded(a, fill):
        return np.concatenate([a, np.full(pad, fill, a.dtype)])

    return dict(
        lane_ix=padded(lane_ix, 0).reshape(M, resolution),
        lane_iy=padded(lane_iy, 0).reshape(M, resolution),
        lane_seed_iy=padded(lane_seed_iy, 0).reshape(M, resolution),
        lane_pixel=padded(lane_pixel, n_pixels),  # flat (M*res,)
        n_hit=n_hit, pad=pad, M=M,
    )


# --------------------------------------------------------------------------
# Device path
# --------------------------------------------------------------------------
@functools.partial(
    jax.jit,
    static_argnames=("n_bins", "resolution"))
def compact_reset(ctx: M.SpectralCtx, lane_ix, lane_iy, lane_seed_iy,
                  n_bins: int, resolution: int) -> M.SpectralState:
    """full_reset over an explicit lane table instead of the pixel grid."""
    sx, sy = geometry.screen_position(lane_ix, lane_iy, 1.0 / resolution)
    rng = sampling.seed_state(lane_ix, lane_seed_iy, ctx.seed_bits)
    lane_shape = lane_ix.shape
    mask = jnp.ones(lane_shape, bool)
    rng, new = M._respawn(rng, mask, sx, sy, ctx, n_bins)
    shape = (n_bins,) + lane_shape
    return M.SpectralState(
        px=new["px"], py=new["py"], pz=new["pz"],
        dx=new["dx"], dy=new["dy"], dz=new["dz"],
        bounces=jnp.zeros(lane_shape, jnp.int32),
        samples=jnp.zeros(lane_shape, jnp.int32),
        bin=new["bin"], wavelength=new["wavelength"],
        radiance=jnp.ones(shape, jnp.float32),
        transmittance=jnp.ones(shape, jnp.float32),
    )


@functools.partial(
    jax.jit,
    static_argnames=("steps", "n_bins", "volume_filter", "resolution"),
    donate_argnames=("state",))
def render_compact_many(state: M.SpectralState, ctx: M.SpectralCtx, seeds,
                        lane_ix, lane_iy, lane_seed_iy,
                        steps: int, n_bins: int, resolution: int,
                        volume_filter: str = "linear"):
    """K dispatches over the compact lane set (scan-batched like
    M.render_many). Lane math is position-independent, so M._render_body
    runs unchanged — only the pixel grid is explicit."""
    sx, sy = geometry.screen_position(lane_ix, lane_iy, 1.0 / resolution)

    def dispatch(p, seed_bits):
        rng = sampling.seed_state(lane_ix, lane_seed_iy, seed_bits)

        def body(_, carry):
            q, r = carry
            q, r, _ = M._render_body(q, r, None, sx, sy, ctx,
                                     n_bins, volume_filter, diff=False)
            return (q, r)

        p, _ = jax.lax.fori_loop(0, steps, body, (p, rng))
        return p, None

    state, _ = jax.lax.scan(dispatch, state, seeds)
    return state


@functools.partial(
    jax.jit,
    static_argnames=("resolution", "streams"))
def compact_image(state: M.SpectralState, lane_pixel, hit_mask,
                  miss_radiance, bin_xyz, resolution: int, streams: int):
    """Scatter lane radiance means back to the framebuffer (mean over each
    pixel's stream lanes, matching radiance_to_rgb's stream average) and
    fill miss pixels with their closed-form radiance."""
    B = state.radiance.shape[0]
    n_pixels = resolution * resolution
    flat = state.radiance.reshape(B, -1)  # (B, L)
    acc = jnp.zeros((B, n_pixels + 1), jnp.float32)
    acc = acc.at[:, lane_pixel].add(flat)
    mean = (acc[:, :n_pixels] / streams).reshape(B, resolution, resolution)
    rad = jnp.where(hit_mask[None], mean, miss_radiance)
    return M.radiance_to_rgb(rad, bin_xyz)
