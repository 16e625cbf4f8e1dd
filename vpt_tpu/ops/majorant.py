"""Super-voxel majorant grid: spatially varying delta-tracking majorants.

The reference's delta tracking uses one global majorant (the `extinction`
uniform scales the TF alpha, so the sampling rate is `extinction` everywhere
— MCMSpectralComputeRenderer.wgsl:123-139). In thin or empty regions that
wastes almost every Woodcock step on null collisions; in the lockstep kernel
each step costs a fixed slate of gathers for *all* lanes, so steps-per-path
is the whole cost model, and a big volume (BASELINE config 5) is dominated
by photons null-colliding their way through near-empty space.

This module builds a small per-scene table that lets each lane take the
longest statistically exact free flight its surroundings allow:

  For every super-voxel cell c the table stores a pair ``(m, r)`` where
  ``m`` >= the TF alpha reachable anywhere within Euclidean distance ``r``
  of any point in c. A lane at x samples its free flight at rate
  ``extinction * m`` and caps it at ``r``:

    - flight < r  -> tentative collision; accepted as a real event with
      probability alpha(x')/m (the standard spatially-varying delta
      tracking acceptance — unbiased for any m >= alpha along the segment);
    - flight >= r -> pure advance by r and resample (exact by the
      exponential's memorylessness).

  The radius is chosen *per cell* to maximize expected progress
  E[min(Exp(ext*m_r), r)] = (1 - exp(-ext*m_r*r))/(ext*m_r) over a ladder
  of pooling radii: empty cells get a huge r (empty-space skipping ~ a
  Chebyshev distance transform), uniform thin regions get a large r with a
  small m (long flights), and cells hugging dense features fall back to
  tight majorants.

Everything is a host-side NumPy precompute (at renderer build) feeding one
extra 2-wide row gather per step in the kernel — the table is ~2 MB for a
512^3 volume at 8^3 blocks, small enough to stay cache-resident.

Estimator contract: image-level parity with the reference-exact path (same
converged expectation, different sample paths / RNG consumption), asserted
statistically by tests/test_majorant.py. The reference-exact global-majorant
path stays the default.

Correctness of the bound chain (all convex-combination filters):
  trilinear/quasicubic density samples are bounded by the max of their 8
  corner voxels, so per-cell density windows include a 1-voxel border; the
  bilinear TF alpha is bounded by the max alpha texel over the touched
  density rows (max over the wavelength axis covers the t interpolation).
"""

from __future__ import annotations

import numpy as np


def _interval_reduce_axis(a: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                          fn, axis: int) -> np.ndarray:
    """Windowed reduce over arbitrary (possibly overlapping, unequal-width)
    inclusive index intervals [lo[c], hi[c]] along ``axis`` — a vectorized
    sparse (power-of-two doubling) table, O(n log n) host-side.
    ``fn``: binary elementwise reduce (np.minimum / np.maximum)."""
    a = np.moveaxis(a, axis, -1)
    n = a.shape[-1]
    levels = [a]
    k = 1
    while (1 << k) <= n:
        half = 1 << (k - 1)
        prev = levels[-1]
        levels.append(fn(prev[..., : prev.shape[-1] - half], prev[..., half:]))
        k += 1
    length = hi - lo + 1
    ks = np.maximum(np.frexp(length.astype(np.float64))[1] - 1, 0)
    out = np.empty(a.shape[:-1] + (len(lo),), a.dtype)
    for kk in np.unique(ks):
        sel = np.where(ks == kk)[0]
        lvl = levels[int(kk)]
        out[..., sel] = fn(lvl[..., lo[sel]], lvl[..., hi[sel] - (1 << int(kk)) + 1])
    return np.moveaxis(out, -1, axis)


def _cell_window_reduce(a: np.ndarray, block: int, fn) -> np.ndarray:
    """Per-cell reduce over exactly the voxels any filtered sample inside the
    cell can touch — with cells defined in NORMALIZED space, matching the
    kernel's ``floor(p * G)`` indexing (mcm_spectral._render_body).

    G = ceil(n / block) cells per axis; cell c covers normalized
    [c/G, (c+1)/G]. A sample at normalized t touches voxels
    floor(t*n - 0.5) and +1 (clamped), so the cell's voxel window is
    [floor((c/G)*n - 0.5), floor(((c+1)/G)*n - 0.5) + 1] clamped to
    [0, n-1]. When n is divisible by ``block`` this reduces to the
    block-slab-with-1-voxel-border window; when it is NOT divisible the
    old slab windows were misaligned with the kernel's uniform 1/G cells
    and the stored majorant could undercount reachable density — a silent
    bias (delta-tracking accepts clamp alpha/m into [0,1]). Boundaries are
    widened by an epsilon so float32 cell assignment in the kernel can
    never land a sample outside its builder window.

    ``fn``: np.minimum or np.maximum. Separable per axis.
    """
    eps = 1e-6
    out = a
    for axis in range(a.ndim):
        n = a.shape[axis]
        G = -(-n // block)
        c = np.arange(G, dtype=np.float64)
        lo = np.floor((c / G - eps) * n - 0.5).astype(np.int64)
        hi = np.floor(((c + 1) / G + eps) * n - 0.5).astype(np.int64) + 1
        lo = np.clip(lo, 0, n - 1)
        hi = np.clip(hi, 0, n - 1)
        out = _interval_reduce_axis(out, lo, hi, fn, axis)
    return out


def _alpha_row_max(tf_table: np.ndarray) -> np.ndarray:
    """Per-density-row upper bound on the TF alpha channel.

    Max over the wavelength axis bounds the bilinear interpolation in t for
    every wavelength; interpolation between two rows is then bounded by the
    max of the two row bounds.
    """
    return np.asarray(tf_table, np.float32)[:, :, 1].max(axis=1)


def _interval_max_table(values: np.ndarray):
    """Sparse table for O(1) max over arbitrary index intervals [a, b]."""
    n = len(values)
    levels = [np.asarray(values, np.float32)]
    k = 1
    while (1 << k) <= n:
        prev = levels[-1]
        half = 1 << (k - 1)
        levels.append(np.maximum(prev[: len(prev) - half], prev[half:]))
        k += 1
    return levels


def _interval_max(levels, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized max(values[a..b]) queries (a <= b, both in range)."""
    length = b - a + 1
    k = np.maximum(np.frexp(length.astype(np.float64))[1] - 1, 0)
    out = np.empty(a.shape, np.float32)
    for kk in np.unique(k):
        lvl = levels[int(kk)]
        sel = k == kk
        lo = a[sel]
        hi = b[sel] - (1 << int(kk)) + 1
        out[sel] = np.maximum(lvl[lo], lvl[hi])
    return out


def _maxpool(m: np.ndarray, rho: int) -> np.ndarray:
    """Chebyshev dilation by ``rho`` cells (separable max filter, 0 padded:
    outside the unit cube there is no material)."""
    out = m
    for axis in range(m.ndim):
        pad = [(0, 0)] * m.ndim
        pad[axis] = (rho, rho)
        p = np.pad(out, pad, mode="constant", constant_values=0.0)
        win = np.lib.stride_tricks.sliding_window_view(p, 2 * rho + 1, axis=axis)
        out = win.max(axis=-1)
    return out


def build_majorant_grid(
    density: np.ndarray,
    tf_table: np.ndarray,
    extinction: float,
    block: int = 8,
    radii=None,
    safety: float = 1e-5,
) -> np.ndarray:
    """Build the (Gz, Gy, Gx, 2) majorant table for a raw (D, H, W) density
    grid and a (Hd, Wt, 4) material TF (alpha = channel 1).

    ``block``: super-voxel edge in voxels. ``radii``: candidate pooling
    radii in cells (powers of two up to the grid size by default).
    ``extinction`` tunes the expected-progress radius choice only — any
    choice is statistically exact, extinction just picks the fastest.
    """
    d = np.asarray(density, np.float32)
    tf = np.asarray(tf_table, np.float32)
    dmin = _cell_window_reduce(d, block, np.minimum)
    dmax = _cell_window_reduce(d, block, np.maximum)

    # density interval -> touched TF rows (sample at s = d*H - 0.5 touches
    # rows floor(s) and floor(s)+1, clamped) -> alpha bound per cell
    Hd = tf.shape[0]
    a = np.clip(np.floor(dmin * Hd - 0.5).astype(np.int64), 0, Hd - 1)
    b = np.clip(np.floor(dmax * Hd - 0.5).astype(np.int64) + 1, 0, Hd - 1)
    levels = _interval_max_table(_alpha_row_max(tf))
    m0 = _interval_max(levels, a, b)  # (Gz, Gy, Gx) alpha majorant per cell

    G = m0.shape
    h_min = 1.0 / max(G)  # normalized cell width (conservative per-axis min)
    if radii is None:
        radii, r = [], 1
        while r <= max(G):
            radii.append(r)
            r *= 2
    ext = max(float(extinction), 1e-6)

    best_progress = np.full(G, -1.0, np.float64)
    best_m = np.zeros(G, np.float32)
    best_r = np.zeros(G, np.float32)
    for rho in radii:
        m_r = _maxpool(m0, rho)
        rng = rho * h_min
        lam = ext * m_r.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            progress = np.where(lam > 0, -np.expm1(-lam * rng) / lam, rng)
        take = progress > best_progress
        best_progress = np.where(take, progress, best_progress)
        best_m = np.where(take, m_r, best_m)
        best_r = np.where(take, np.float32(rng), best_r)

    table = np.stack([best_m * (1.0 + safety), best_r], axis=-1)
    return np.ascontiguousarray(table, np.float32)
