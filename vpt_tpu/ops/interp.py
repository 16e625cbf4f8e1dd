"""Explicit texture sampling: XLA exposes no texture sampler, so GPU-style
nearest/linear/quasi-cubic filtering with clamp-to-edge addressing is done
with gathers + arithmetic.

Semantics match WebGPU ``textureSampleLevel`` with normalized coordinates:
texel centers at (i + 0.5)/N, linear filter weights from the fractional
offset, clamp-to-edge addressing. Quasi-cubic mode is the smoothstep-warped
trilinear of /root/reference/src/glsl/mixins/quasiCubicSampling.glsl:3-9.

Gathers lower to XLA's gather; the product ships no hand-written kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
class PackedVolume:
    """A packed corner table stored FLAT: (rows, C) + static padded dims.

    Stored flat so each corner row is one contiguous run of C values,
    whatever layout the compiler would pick for a 4-D array.

    ``dims``: the padded 3-D table dims — (D+1, H+1, W+1) for kind="full"
    (C=8), (D, H+1, W+1) for kind="xy" (C=4). Registered as a pytree with
    static (dims, kind) so it travels through jit/scan/shard_map like an
    array.
    """

    def __init__(self, table, dims, kind: str):
        self.table = table
        self.dims = tuple(int(d) for d in dims)
        self.kind = kind

    def tree_flatten(self):
        return (self.table,), (self.dims, self.kind)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    @property
    def width(self) -> int:
        return 4 if self.kind == "xy" else 8

    @property
    def shape4(self):
        """The logical 4-D packed shape (what pack_volume_corners* emit)."""
        return self.dims + (self.width,)

    @property
    def n_rows(self) -> int:
        d = self.dims
        return d[0] * d[1] * d[2]

    @staticmethod
    def pack(density, kind: str = "full",
             table_dtype: str = "f32") -> "PackedVolume":
        """Build from a raw (D, H, W) grid (host-side, one device upload).

        ``table_dtype``: "f32" (default), "u8" (quarter bytes; BIT-EXACT
        when the source volume is u8-quantized — i.e. every density equals
        round(d*255)/255, the volume readers' native format — and the
        samplers dequantize with the identical astype(f32)/255
        expression), or "bf16" (half bytes, lossy ~2^-9 relative)."""
        import numpy as np

        packed = (pack_volume_corners_xy if kind == "xy"
                  else pack_volume_corners)(density)
        dims = packed.shape[:3]
        flat = packed.reshape(-1, packed.shape[-1])
        if table_dtype == "u8":
            q = np.round(flat * 255.0)
            assert np.allclose(q / 255.0, flat, atol=1e-7), (
                "u8 packed tables require a u8-quantized source volume "
                "(every density == k/255); use table_dtype='bf16' or 'f32'")
            flat = q.astype(np.uint8)
        elif table_dtype == "bf16":
            flat = jnp.asarray(flat, jnp.bfloat16)
        elif table_dtype != "f32":
            raise ValueError(f"unknown table_dtype {table_dtype!r}")
        return PackedVolume(jnp.asarray(flat), dims, kind)

    @staticmethod
    def from_packed4d(packed, kind: str | None = None) -> "PackedVolume":
        """Wrap an existing 4-D packed table (reshaped flat)."""
        if kind is None:
            kind = "xy" if packed.shape[-1] == 4 else "full"
        return PackedVolume(
            jnp.asarray(packed).reshape(-1, packed.shape[-1]),
            packed.shape[:3], kind,
        )


def pack_volume_auto(density, kind: str = "full", table_dtype: str = "auto"):
    """Pack a raw (D, H, W) grid into a flat PackedVolume.

    ``table_dtype``: "auto" (default) stores u8 whenever the source volume
    is u8-quantized (every density == k/255 — the volume readers' native
    format): bit-exact, and a quarter of the f32 table's bytes. Other
    sources store f32. Explicit "f32" / "u8" / "bf16" force a dtype."""
    import numpy as np

    if table_dtype == "auto":
        # exactness checked on the RAW grid (corners are copies of raw
        # values; the packed table is 4-8x bigger)
        d = np.asarray(density)
        q = np.round(d * 255.0)
        table_dtype = "u8" if np.allclose(q / 255.0, d, atol=1e-7) else "f32"
    return PackedVolume.pack(density, kind, table_dtype=table_dtype)


def _coords(u, n):
    """Normalized coord -> (lo index, hi index, frac) with clamp-to-edge."""
    t = u * n - 0.5
    i0 = jnp.floor(t)
    frac = t - i0
    base = i0.astype(jnp.int32)
    i0 = jnp.clip(base, 0, n - 1)
    i1 = jnp.clip(base + 1, 0, n - 1)
    return i0, i1, frac


def _nearest_coords(u, n):
    i = jnp.clip(jnp.floor(u * n).astype(jnp.int32), 0, n - 1)
    return i


def pack_volume_corners(density):
    """Precompute every trilinear footprint as one contiguous 8-value row.

    Packing turns the 8 corner fetches of trilinear sampling into a single
    gather of 8 contiguous values, at 8x memory. Whether that beats the
    8-tap raw lookup on a given device is a measurement (ROADMAP Speed 3).

    Input (D, H, W); output (D+1, H+1, W+1, 8) where row [z, y, x] holds the
    corners of the cell whose low corner is voxel (z-1, y-1, x-1) of the
    edge-padded volume — together with the shifted base index in
    ``sample_volume`` this reproduces independent per-corner clamp-to-edge
    semantics bit-exactly (both-sides edge padding).

    Corner order: bit2 = z, bit1 = y, bit0 = x (c000, c001, c010, ... c111).
    """
    import numpy as np

    d = np.asarray(density)
    p = np.pad(d, 1, mode="edge")  # (D+2, H+2, W+2)
    corners = np.stack(
        [
            p[:-1, :-1, :-1], p[:-1, :-1, 1:],
            p[:-1, 1:, :-1], p[:-1, 1:, 1:],
            p[1:, :-1, :-1], p[1:, :-1, 1:],
            p[1:, 1:, :-1], p[1:, 1:, 1:],
        ],
        axis=-1,
    )
    return np.ascontiguousarray(corners, dtype=d.dtype)


def pack_volume_corners_xy(density):
    """Half-packed volume: each row holds the 4 xy-corners of one depth
    plane — output (D, H+1, W+1, 4). Trilinear sampling then needs TWO row
    gathers (z0 and z1 planes) instead of eight scalar ones, at 4x memory
    instead of the full table's 8x.

    This is the big-volume mode: a 512^3 grid's full f32 corner table is
    4.3 GB where the xy table is 2.1 GB, so 2 gathers/step is the packed
    option when the 8x table does not fit the device. Bit-identical to the
    raw 8-gather path.
    """
    import numpy as np

    d = np.asarray(density)
    p = np.pad(d, ((0, 0), (1, 1), (1, 1)), mode="edge")  # (D, H+2, W+2)
    corners = np.stack(
        [p[:, :-1, :-1], p[:, :-1, 1:], p[:, 1:, :-1], p[:, 1:, 1:]],
        axis=-1,
    )
    return np.ascontiguousarray(corners, dtype=d.dtype)


def _sample_volume_packed_xy(flat, dims, u, v, w, mode):
    """Two-gather trilinear sampling of a pack_volume_corners_xy table
    ((rows, 4) flat + padded dims (D, H+1, W+1))."""
    D, Hp, Wp = dims
    H, W = Hp - 1, Wp - 1

    def base_and_frac(t, n):
        s = t * n - 0.5
        i0 = jnp.floor(s)
        return i0.astype(jnp.int32), s - i0

    bx, fx = base_and_frac(u, W)
    by, fy = base_and_frac(v, H)
    bz, fz = base_and_frac(w, D)
    # xy use the padded-table scheme (+1, clamp to [0, n]); z planes are
    # unpadded, so clamp both plane indices like the raw path's _coords
    bx = jnp.clip(bx + 1, 0, W)
    by = jnp.clip(by + 1, 0, H)
    z0 = jnp.clip(bz, 0, D - 1)
    z1 = jnp.clip(bz + 1, 0, D - 1)

    if mode == "quasicubic":
        fx = fx * fx * (3.0 - 2.0 * fx)
        fy = fy * fy * (3.0 - 2.0 * fy)
        fz = fz * fz * (3.0 - 2.0 * fz)
    elif mode != "linear":
        raise ValueError(f"packed volumes support linear/quasicubic, not {mode!r}")

    plane = by * Wp + bx
    r0 = _dequantize_rows(jnp.take(flat, z0 * (Hp * Wp) + plane, axis=0))
    r1 = _dequantize_rows(jnp.take(flat, z1 * (Hp * Wp) + plane, axis=0))
    c000, c001, c010, c011 = r0[..., 0], r0[..., 1], r0[..., 2], r0[..., 3]
    c100, c101, c110, c111 = r1[..., 0], r1[..., 1], r1[..., 2], r1[..., 3]

    c00 = c000 + (c001 - c000) * fx
    c01 = c010 + (c011 - c010) * fx
    c10 = c100 + (c101 - c100) * fx
    c11 = c110 + (c111 - c110) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    return c0 + (c1 - c0) * fz


def pack_volume_corners_jnp(density):
    """Differentiable (jnp) pack_volume_corners — same values bit-for-bit.

    Packing inside a differentiated function makes the gradient path cheap:
    the forward costs ONE row gather per sample (vs 8 scalar gathers from the
    raw grid), the backward ONE row scatter-add into the packed table, and
    autodiff of this function then contracts the packed-table adjoint back to
    the raw grid with dense shifted adds (the pack transpose): 8x fewer
    gather/scatter indices on the differentiable render path.
    """
    p = jnp.pad(density, 1, mode="edge")
    return jnp.stack(
        [
            p[:-1, :-1, :-1], p[:-1, :-1, 1:],
            p[:-1, 1:, :-1], p[:-1, 1:, 1:],
            p[1:, :-1, :-1], p[1:, :-1, 1:],
            p[1:, 1:, :-1], p[1:, 1:, 1:],
        ],
        axis=-1,
    )


def pack_volume_corners_xy_jnp(density):
    """Differentiable (jnp) pack_volume_corners_xy — same values bit-for-bit.

    Exists mainly for its transpose: the packed-adjoint backward
    (kernels/spectral_backward) scatters gradients into xy-packed rows and
    contracts them back to the raw grid through jax.vjp of this function.
    """
    p = jnp.pad(density, ((0, 0), (1, 1), (1, 1)), mode="edge")
    return jnp.stack(
        [p[:, :-1, :-1], p[:, :-1, 1:], p[:, 1:, :-1], p[:, 1:, 1:]],
        axis=-1,
    )


def pack_tex2d_corners_jnp(tex):
    """Differentiable pack_tex2d_corners (same values)."""
    p = jnp.pad(tex, ((1, 1), (1, 1), (0, 0)), mode="edge")
    return jnp.concatenate([p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]], axis=-1)


def pack_tex1d_corners_jnp(tex):
    """Differentiable pack_tex1d_corners (same values)."""
    p = jnp.pad(tex, 1, mode="edge")
    return jnp.stack([p[:-1], p[1:]], axis=-1)


def pack_tex2d_with_tex1d_jnp(tex2d, tex1d):
    """Differentiable pack_tex2d_with_tex1d (same values) — lets an
    optimizer re-fuse learned raw TF/light tables into the (H+1, W+1, 18)
    fast-path table inside a jitted step (optim.make_spectral_prb_step)."""
    t2 = pack_tex2d_corners_jnp(tex2d)
    t1 = pack_tex1d_corners_jnp(tex1d)
    Hp, Wp, _ = t2.shape
    if t1.shape[0] != Wp:
        raise ValueError(
            f"1D table length {t1.shape[0] - 1} != 2D texture width {Wp - 1}"
        )
    aux = jnp.broadcast_to(t1[None], (Hp, Wp, 2))
    return jnp.concatenate([t2, aux], axis=-1)


# Bit-exact u8 dequantization: XLA lowers x / 255.0 to a reciprocal
# multiply that differs from the host readers' IEEE division by 1 ulp for
# 126 of the 256 code points. A two-term constant split does not fix it
# (k * c_hi already rounds, and that rounding error is what the correction
# must capture). The correct form is one Newton residual step:
# t = k*c; r = k - t*255; out = t + r*c — exact for all 256 codes in
# faithful f32 arithmetic (r recovers t's rounding error scaled by 255,
# exactly representable because k and 255*t are close). The
# optimization_barrier keeps XLA's algebraic simplifier from folding the
# whole expression back to the single reciprocal multiply. Checked over
# all 256 codes, isolated and inside the sampler, on the CPU
# (tests/test_packed_tables.py) and on the GPU (bench.py, chip_smoke.py).
_INV255 = np.float32(1.0 / 255.0)


def _dequantize_rows(rows):
    """Gathered corner rows -> f32 lerp operands. Quantized table dtypes
    (fewer bytes per gathered row): u8
    dequantizes bit-exactly to the readers' `x.astype(f32)/255` values
    via a barriered Newton residual step (see _INV255 comment), so
    u8-quantized source volumes round-trip EXACTLY; bf16 is a lossy
    opt-in (~2^-9 relative)."""
    if rows.dtype == jnp.uint8:
        rf = rows.astype(jnp.float32)
        t = jax.lax.optimization_barrier(rf * _INV255)
        r = rf - t * jnp.float32(255.0)
        return t + r * _INV255
    if rows.dtype != jnp.float32:
        return rows.astype(jnp.float32)
    return rows


def _sample_volume_packed(flat, dims, u, v, w, mode):
    """Single-gather trilinear/quasi-cubic sampling of a packed corner table
    ((rows, 8) flat + padded dims (D+1, H+1, W+1))."""
    Dp, Hp, Wp = dims
    D, H, W = Dp - 1, Hp - 1, Wp - 1

    def base_and_frac(t, n):
        s = t * n - 0.5
        i0 = jnp.floor(s)
        frac = s - i0
        # +1 into the padded table; clamp keeps both pair elements equal to
        # the edge texel outside [0, n-1] (matches per-corner clamping)
        return jnp.clip(i0.astype(jnp.int32) + 1, 0, n), frac

    bx, fx = base_and_frac(u, W)
    by, fy = base_and_frac(v, H)
    bz, fz = base_and_frac(w, D)

    if mode == "quasicubic":
        fx = fx * fx * (3.0 - 2.0 * fx)
        fy = fy * fy * (3.0 - 2.0 * fy)
        fz = fz * fz * (3.0 - 2.0 * fz)
    elif mode != "linear":
        raise ValueError(f"packed volumes support linear/quasicubic, not {mode!r}")

    rows = jnp.take(flat, (bz * Hp + by) * Wp + bx, axis=0)
    rows = _dequantize_rows(rows)
    c000, c001, c010, c011 = rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3]
    c100, c101, c110, c111 = rows[..., 4], rows[..., 5], rows[..., 6], rows[..., 7]

    # pairwise lerps in the same order as the 8-gather path (bit-identical)
    c00 = c000 + (c001 - c000) * fx
    c01 = c010 + (c011 - c010) * fx
    c10 = c100 + (c101 - c100) * fx
    c11 = c110 + (c111 - c110) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    return c0 + (c1 - c0) * fz


def sample_volume(density, u, v, w, mode: str = "linear"):
    """Sample a scalar volume at normalized (u,v,w) -> density lanes.

    (u,v,w) maps to (x,y,z): u indexes W, v indexes H, w indexes D —
    the 3D-texture convention the renderers rely on.

    ``density`` is a raw (D, H, W) grid, a PackedVolume (the fast path:
    flat corner table + static dims), or a 4-D packed corner table (the
    slab-sharded path and in-graph packing pass these).
    """
    if isinstance(density, PackedVolume):
        fn = _sample_volume_packed_xy if density.kind == "xy" else _sample_volume_packed
        return fn(density.table, density.dims, u, v, w, mode)
    if density.ndim == 4:
        flat = density.reshape(-1, density.shape[-1])
        if density.shape[-1] == 4:  # xy half-packed (big-volume mode)
            return _sample_volume_packed_xy(flat, density.shape[:3], u, v, w, mode)
        return _sample_volume_packed(flat, density.shape[:3], u, v, w, mode)
    D, H, W = density.shape
    flat = density.reshape(-1)

    if mode == "nearest":
        ix = _nearest_coords(u, W)
        iy = _nearest_coords(v, H)
        iz = _nearest_coords(w, D)
        return jnp.take(flat, (iz * H + iy) * W + ix, axis=0)

    x0, x1, fx = _coords(u, W)
    y0, y1, fy = _coords(v, H)
    z0, z1, fz = _coords(w, D)

    if mode == "quasicubic":
        # smoothstep-warp the interpolation weights (quasiCubicSampling.glsl)
        fx = fx * fx * (3.0 - 2.0 * fx)
        fy = fy * fy * (3.0 - 2.0 * fy)
        fz = fz * fz * (3.0 - 2.0 * fz)
    elif mode != "linear":
        raise ValueError(f"unknown volume filter {mode!r}")

    def fetch(iz, iy, ix):
        return jnp.take(flat, (iz * H + iy) * W + ix, axis=0)

    c000 = fetch(z0, y0, x0)
    c001 = fetch(z0, y0, x1)
    c010 = fetch(z0, y1, x0)
    c011 = fetch(z0, y1, x1)
    c100 = fetch(z1, y0, x0)
    c101 = fetch(z1, y0, x1)
    c110 = fetch(z1, y1, x0)
    c111 = fetch(z1, y1, x1)

    c00 = c000 + (c001 - c000) * fx
    c01 = c010 + (c011 - c010) * fx
    c10 = c100 + (c101 - c100) * fx
    c11 = c110 + (c111 - c110) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    return c0 + (c1 - c0) * fz


def pack_tex2d_corners(tex):
    """Pack a (H, W, C) texture's bilinear footprints into one row each:
    output (H+1, W+1, 4*C), corner order (y0x0, y0x1, y1x0, y1x1), channels
    fastest. Same single-gather rationale as pack_volume_corners."""
    import numpy as np

    t = np.asarray(tex)
    p = np.pad(t, ((1, 1), (1, 1), (0, 0)), mode="edge")
    corners = np.concatenate(
        [p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]], axis=-1
    )
    return np.ascontiguousarray(corners, dtype=t.dtype)


def _sample_tex2d_packed(packed, u, v, C):
    Hp, Wp, C4 = packed.shape
    assert C4 == 4 * C
    H, W = Hp - 1, Wp - 1

    def base_and_frac(t, n):
        s = t * n - 0.5
        i0 = jnp.floor(s)
        return jnp.clip(i0.astype(jnp.int32) + 1, 0, n), s - i0

    bx, fx = base_and_frac(u, W)
    by, fy = base_and_frac(v, H)
    rows = jnp.take(packed.reshape(-1, C4), by * Wp + bx, axis=0)
    c00 = rows[..., 0 * C : 1 * C]
    c01 = rows[..., 1 * C : 2 * C]
    c10 = rows[..., 2 * C : 3 * C]
    c11 = rows[..., 3 * C : 4 * C]
    fx = fx[..., None]
    fy = fy[..., None]
    c0 = c00 + (c01 - c00) * fx
    c1 = c10 + (c11 - c10) * fx
    return c0 + (c1 - c0) * fy


def sample_tex2d(tex, u, v):
    """Bilinear sample of a texture at normalized (u, v).

    u indexes W (x), v indexes H (y). Returns (..., C).

    ``tex``: raw (H, W, C) with C <= 4, or a packed corner table from
    pack_tex2d_corners (trailing dim 4*C > 4 — the single-gather fast path).
    """
    if tex.shape[-1] > 4 and tex.shape[-1] % 4 == 0:
        return _sample_tex2d_packed(tex, u, v, tex.shape[-1] // 4)
    H, W, C = tex.shape
    flat = tex.reshape(-1, C)
    x0, x1, fx = _coords(u, W)
    y0, y1, fy = _coords(v, H)

    def fetch(iy, ix):
        return jnp.take(flat, iy * W + ix, axis=0)

    c00 = fetch(y0, x0)
    c01 = fetch(y0, x1)
    c10 = fetch(y1, x0)
    c11 = fetch(y1, x1)
    fx = fx[..., None]
    fy = fy[..., None]
    c0 = c00 + (c01 - c00) * fx
    c1 = c10 + (c11 - c10) * fx
    return c0 + (c1 - c0) * fy


def pack_tex2d_with_tex1d(tex2d, tex1d):
    """Fuse a (W,) 1D table that shares the 2D texture's x coordinate into
    the packed corner rows: output (H+1, W+1, 4*C + 2).

    Rationale: a lookup pair that shares its index can ride one gather
    instead of two. The spectral MCM
    kernel samples the material TF at (wavelength_t, density) and the light
    spectrum at wavelength_t with the SAME normalized x coordinate and the
    same 256-texel width (reference MCMSpectralComputeRenderer.wgsl:62-80),
    so the light's packed linear pair is appended to every TF row of its
    column — the TF gather then also returns the light pair and the separate
    light lookup disappears entirely.
    """
    import numpy as np

    t2 = pack_tex2d_corners(tex2d)  # (H+1, W+1, 4C)
    t1 = pack_tex1d_corners(tex1d)  # (W+1, 2)
    Hp, Wp, _ = t2.shape
    if t1.shape[0] != Wp:
        raise ValueError(
            f"1D table length {t1.shape[0] - 1} != 2D texture width {Wp - 1}"
        )
    aux = np.broadcast_to(t1[None], (Hp, Wp, 2))
    return np.ascontiguousarray(np.concatenate([t2, aux], axis=-1), t2.dtype)


def sample_tex2d_fused1d(packed, u, v, C: int = 4, return_extras: bool = False):
    """Sample a pack_tex2d_with_tex1d table at normalized (u, v).

    Returns (mat (..., C), aux scalar) where ``mat`` is bit-identical to
    sample_tex2d of the packed 2D table and ``aux`` is bit-identical to
    sample_tex1d of the packed 1D table at ``u`` — one gather for both.

    ``return_extras``: additionally return dict(rows, row_idx, fx, fy) —
    the gathered corner rows and addressing, which the packed-adjoint
    backward (kernels/spectral_backward) reuses to compute TF slopes and
    scatter gradient rows without a second gather.
    """
    Hp, Wp, CC = packed.shape
    assert CC == 4 * C + 2
    H, W = Hp - 1, Wp - 1

    def base_and_frac(t, n):
        s = t * n - 0.5
        i0 = jnp.floor(s)
        return jnp.clip(i0.astype(jnp.int32) + 1, 0, n), s - i0

    bx, fx = base_and_frac(u, W)
    by, fy = base_and_frac(v, H)
    row_idx = by * Wp + bx
    rows = jnp.take(packed.reshape(-1, CC), row_idx, axis=0)
    c00 = rows[..., 0 * C : 1 * C]
    c01 = rows[..., 1 * C : 2 * C]
    c10 = rows[..., 2 * C : 3 * C]
    c11 = rows[..., 3 * C : 4 * C]
    fxc = fx[..., None]
    fyc = fy[..., None]
    c0 = c00 + (c01 - c00) * fxc
    c1 = c10 + (c11 - c10) * fxc
    mat = c0 + (c1 - c0) * fyc
    l0 = rows[..., 4 * C]
    l1 = rows[..., 4 * C + 1]
    aux = l0 + (l1 - l0) * fx
    if return_extras:
        return mat, aux, dict(rows=rows, row_idx=row_idx, fx=fx, fy=fy)
    return mat, aux


def pack_tex1d_corners(tex):
    """(N,) -> (N+1, 2) pair rows: one gather instead of two per sample."""
    import numpy as np

    t = np.asarray(tex)
    p = np.pad(t, 1, mode="edge")
    return np.ascontiguousarray(np.stack([p[:-1], p[1:]], axis=-1), dtype=t.dtype)


def sample_tex1d(tex, u):
    """Linear sample of a (N,) texture (or an (N+1, 2) packed pair table
    from pack_tex1d_corners) at normalized u. The packed path gathers one
    pair row per sample."""
    if tex.ndim == 2:
        N = tex.shape[0] - 1
        s = u * N - 0.5
        i0 = jnp.floor(s)
        frac = s - i0
        b = jnp.clip(i0.astype(jnp.int32) + 1, 0, N)
        rows = jnp.take(tex, b, axis=0)
        return rows[..., 0] + (rows[..., 1] - rows[..., 0]) * frac
    (N,) = tex.shape
    x0, x1, fx = _coords(u, N)
    c0 = jnp.take(tex, x0, axis=0)
    c1 = jnp.take(tex, x1, axis=0)
    return c0 + (c1 - c0) * fx
