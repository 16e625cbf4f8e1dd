"""Slab-sharded volumes: render with the density grid partitioned across
devices (for volumes beyond one device's memory), bit-identical to the
replicated path.

Design (SURVEY.md §2.10 "TP analog"): the packed corner table shards along
its leading (z) dimension over the "rays" mesh axis — each device owns a
contiguous slab of rows. A Woodcock step's volume fetch becomes a *routed
distributed gather*:

    1. all_gather the flat row indices of every device's rays  (NCCL)
    2. each owner gathers values for the full request set from its slab
       (rows outside the slab contribute zeros)
    3. reduce_scatter sums the per-owner partial results and hands each
       device back exactly its own rays' rows                  (NCCL)

Because the gathered *values* are identical regardless of where rows are
stored, slab-mode renders are bit-identical to replicated-volume renders —
which is exactly what the test asserts on a virtual 8-device mesh.

Everything else in the dispatch is elementwise per lane, so the whole
megakernel runs under one shard_map with only these two collectives per
step. Communication per step: n*N indices + N*8 floats per device.

Sample streams compose with slab mode: (S, H, W) lanes shard the H axis
like the replicated path. The super-voxel majorant table (ctx.majorant),
when present, stays replicated — it is ~MBs where the corner table is GBs,
so sharding it would add collectives for no memory win.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from vpt_tpu.models import mcm_spectral as M
from vpt_tpu.ops import geometry, sampling

AXIS = "rays"


def pad_packed_for_slabs(packed: np.ndarray, n_devices: int) -> np.ndarray:
    """Zero-pad the packed corner table's z dim to a multiple of n_devices
    (pad rows are never addressed: base indices stay within the original)."""
    Dp = packed.shape[0]
    pad = (-Dp) % n_devices
    if pad:
        packed = np.concatenate(
            [packed, np.zeros((pad,) + packed.shape[1:], packed.dtype)], axis=0
        )
    return packed


def shard_packed_volume(packed, mesh) -> jax.Array:
    """Place the (padded) packed table slab-sharded over the mesh."""
    return jax.device_put(
        jnp.asarray(packed), NamedSharding(mesh, P(AXIS, None, None, None))
    )


def _distributed_rows(packed_slab, flat_idx, rows_per_device, hw8):
    """The routed gather (runs inside shard_map). ``packed_slab``:
    (slab_z, Hp, Wp, 8) local slab; ``flat_idx``: (N,) local flat ROW
    indices into the global (Dp*Hp*Wp) row space."""
    me = jax.lax.axis_index(AXIS)
    lo = me * rows_per_device

    all_idx = jax.lax.all_gather(flat_idx, AXIS, tiled=True)  # (n*N,)
    local = all_idx - lo
    in_slab = (local >= 0) & (local < rows_per_device)
    safe = jnp.clip(local, 0, rows_per_device - 1)
    rows = jnp.take(packed_slab.reshape(-1, 8), safe, axis=0)
    # dequantize BEFORE masking/summing: a u8/bf16 auto-packed table would
    # otherwise feed raw integer codes into the lerp; for f32
    # tables this is an identity passthrough (bit-identical)
    from vpt_tpu.ops.interp import _dequantize_rows

    rows = _dequantize_rows(rows)
    rows = jnp.where(in_slab[:, None], rows, 0.0)
    # sum over owners and scatter each device its own segment back
    return jax.lax.psum_scatter(rows, AXIS, scatter_dimension=0, tiled=True)


def _sample_volume_slab(packed_slab, u, v, w, rows_per_device, dims, mode):
    """Trilinear sample against the slab-sharded packed table (lane arrays
    are local shards inside shard_map)."""
    D, H, W = dims
    Hp, Wp = H + 1, W + 1

    def base_and_frac(t, n):
        s = t * n - 0.5
        i0 = jnp.floor(s)
        return jnp.clip(i0.astype(jnp.int32) + 1, 0, n), s - i0

    bx, fx = base_and_frac(u, W)
    by, fy = base_and_frac(v, H)
    bz, fz = base_and_frac(w, D)
    if mode == "quasicubic":
        fx = fx * fx * (3.0 - 2.0 * fx)
        fy = fy * fy * (3.0 - 2.0 * fy)
        fz = fz * fz * (3.0 - 2.0 * fz)

    flat = ((bz * Hp + by) * Wp + bx).reshape(-1)
    rows = _distributed_rows(packed_slab, flat, rows_per_device, Hp * Wp * 8)
    rows = rows.reshape(u.shape + (8,))
    c000, c001, c010, c011 = rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3]
    c100, c101, c110, c111 = rows[..., 4], rows[..., 5], rows[..., 6], rows[..., 7]
    c00 = c000 + (c001 - c000) * fx
    c01 = c010 + (c011 - c010) * fx
    c10 = c100 + (c101 - c100) * fx
    c11 = c110 + (c111 - c110) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    return c0 + (c1 - c0) * fz


def _distributed_scatter_add(adj_slab, flat_idx, updates, rows_per_device):
    """The routed adjoint scatter — the exact transpose of
    ``_distributed_rows``: all_gather every device's (row index, update
    row) pairs (NCCL over NVLink), then each owner scatter-adds the subset
    that falls in its slab. No device ever materializes the full packed
    adjoint.

    ``adj_slab``: (rows_per_device, C) local adjoint slab; ``flat_idx``:
    (N,) local GLOBAL row indices; ``updates``: (N, C) local update rows.
    """
    me = jax.lax.axis_index(AXIS)
    lo = me * rows_per_device
    all_idx = jax.lax.all_gather(flat_idx, AXIS, tiled=True)  # (n*N,)
    all_upd = jax.lax.all_gather(updates, AXIS, tiled=True)   # (n*N, C)
    local = all_idx - lo
    in_slab = (local >= 0) & (local < rows_per_device)
    safe = jnp.where(in_slab, local, 0)
    upd = jnp.where(in_slab[:, None], all_upd, 0.0)
    return adj_slab.at[safe].add(upd)


def _unpad_transpose(a, bit, axis):
    """Transpose of one edge-pad axis of interp.pack_volume_corners_jnp:
    packed length N+1 along ``axis`` -> raw length N. Forward corner fetch
    was p[k + bit] with p = edge-pad(d, 1), i.e. d[clip(k + bit - 1,
    0, N-1)]; the transpose folds the clipped ends back in."""
    N = a.shape[axis] - 1
    sl = [slice(None)] * a.ndim

    def ax(i):
        s = list(sl)
        s[axis] = i
        return tuple(s)

    if bit == 0:
        g = a[ax(slice(1, None))]
        return g.at[ax(0)].add(a[ax(0)])
    g = a[ax(slice(0, N))]
    return g.at[ax(N - 1)].add(a[ax(N)])


def _contract_slab_adjoint(adj_flat, D, H, W, slab_z):
    """Local slab of the packed-corner adjoint -> this device's z-slab of
    the RAW density gradient (the distributed transpose of
    pack_volume_corners_jnp).

    The packed table's z is slab-sharded; each packed plane z contributes
    to raw planes z-1 (corners with z-bit 0) and z (z-bit 1), clipped to
    [0, D-1] — so a slab's contribution spans one plane below its range,
    handled by a single ``ppermute`` halo send to the previous device.
    Runs inside shard_map; returns (slab_z, H, W) local raw-grad planes
    (global planes >= D are zero; the caller slices [:D])."""
    Hp, Wp = H + 1, W + 1
    A = adj_flat.reshape(slab_z, Hp, Wp, 8)
    me = jax.lax.axis_index(AXIS)
    lo = me * slab_z  # global packed z of A[0]

    B0 = jnp.zeros((slab_z, H, W), jnp.float32)
    B1 = jnp.zeros((slab_z, H, W), jnp.float32)
    for c in range(8):
        bz, by, bx = (c >> 2) & 1, (c >> 1) & 1, c & 1
        g = _unpad_transpose(_unpad_transpose(A[..., c], by, 1), bx, 2)
        if bz == 0:
            B0 = B0 + g
        else:
            B1 = B1 + g

    # local partial over raw planes [lo-1, lo+slab_z-1] (length slab_z+1)
    zero_plane = jnp.zeros((1, H, W), jnp.float32)
    L = (jnp.concatenate([B0, zero_plane], axis=0)
         + jnp.concatenate([zero_plane, B1], axis=0))

    planes = (lo - 1) + jnp.arange(slab_z + 1, dtype=jnp.int32)
    # fold raw plane -1 (from global packed z=0, corner z-bit 0) into 0 —
    # purely local: plane 0 is this device's L[1] exactly when lo == 0
    L = L.at[1].add(jnp.where(planes[0] < 0, L[0], 0.0))
    # fold raw planes >= D (from packed z >= D; only z == D is nonzero —
    # greater z are zero pad rows) into D-1. D-1 sits at local index
    # D - lo when lo <= D; when lo == D that is L[0], which the halo
    # ppermute then carries to the previous device's top plane.
    mask_hi = (planes >= D)[:, None, None]
    overflow = jnp.sum(jnp.where(mask_hi, L, 0.0), axis=0)
    L = jnp.where(mask_hi, 0.0, L)
    kstar = jnp.clip(D - lo, 0, slab_z)
    L = L.at[kstar].add(overflow)

    n = jax.lax.axis_size(AXIS)
    halo = jax.lax.ppermute(L[0], AXIS,
                            [(i, i - 1) for i in range(1, n)])
    out = L[1:]
    return out.at[slab_z - 1].add(halo)


def prb_grads_slab(state, ctx, mesh, volume_dims, g_image, steps: int,
                   n_bins: int, volume_filter: str = "linear",
                   scatter_stride: int = 1, scatter_mode: str = "stride",
                   lower_only: bool = False):
    """Packed-PRB density gradients of one render dispatch with the volume
    slab-sharded (the composition matrix's last cell).

    Same taped path-replay backward as
    kernels.spectral_backward.spectral_backward_packed with wrt={"density"},
    under one shard_map where (a) the forward's volume fetch is the routed
    distributed gather and (b) the per-step volume-adjoint scatter routes
    the same way in reverse (_distributed_scatter_add) — each device's
    packed-adjoint slab stays (rows/n, 8) through the whole reverse scan;
    the full adjoint is NEVER materialized. The packed->raw contraction is
    also distributed (_contract_slab_adjoint: local pack-transpose + one
    ppermute halo).

    ``ctx.density``: the slab-sharded padded packed table
    (shard_packed_volume); other ctx leaves replicated; lanes row-sharded.
    Returns (state_out, image, {"density": (D, H, W) raw gradient}) —
    allclose to the replicated packed-PRB gradient (tests/test_slab.py).
    """
    from vpt_tpu.kernels import spectral_backward as SB

    n = mesh.devices.size
    resolution = state.px.shape[-1]
    streams = state.px.shape[0] if state.px.ndim == 3 else 1
    D, H, W = volume_dims
    Dp_padded = ctx.density.shape[0]
    slab_z = Dp_padded // n
    rows_per_device = slab_z * (H + 1) * (W + 1)
    rows_local = resolution // n

    lane = P(AXIS, None) if streams == 1 else P(None, AXIS, None)
    binned = P(None, AXIS, None) if streams == 1 else P(None, None, AXIS, None)
    state_specs = M.SpectralState(
        px=lane, py=lane, pz=lane, dx=lane, dy=lane, dz=lane,
        bounces=lane, samples=lane, bin=lane, wavelength=lane,
        radiance=binned, transmittance=binned,
    )
    ctx_specs = M.SpectralCtx(
        inv_mvp=P(), seed_bits=P(), extinction=P(), blur=P(),
        max_bounces=P(), light_direction=P(),
        density=P(AXIS, None, None, None),
        material_tf=P(), light_spectrum=P(), boundaries=P(), bin_xyz=P(),
        environment=None if ctx.environment is None else P(),
        majorant=None if ctx.majorant is None else P(),
    )

    def shard_fn(state, ctx, g_img):
        me = jax.lax.axis_index(AXIS)
        shape = (rows_local, resolution) if streams == 1 else (
            streams, rows_local, resolution)
        iy_local = jax.lax.broadcasted_iota(jnp.uint32, shape, len(shape) - 2)
        ix = jax.lax.broadcasted_iota(jnp.uint32, shape, len(shape) - 1)
        iy = iy_local + me.astype(jnp.uint32) * jnp.uint32(rows_local)
        seed_iy = iy
        if streams > 1:
            s = jax.lax.broadcasted_iota(jnp.uint32, shape, 0)
            seed_iy = iy + s * jnp.uint32(resolution)
        sx, sy = geometry.screen_position(ix, iy, 1.0 / resolution)
        seed_fn = lambda bits: sampling.seed_state(ix, seed_iy, bits)

        def slab_sampler(density, u, v, w, mode="linear"):
            return _sample_volume_slab(
                density, u, v, w, rows_per_device, (D, H, W), mode)

        def slab_scatter(adj, idx, upd):
            return _distributed_scatter_add(adj, idx, upd, rows_per_device)

        adj_in = {"g_vol": jnp.zeros((rows_per_device, 8), jnp.float32)}
        state_out, image, acc = SB.spectral_backward_packed(
            state, ctx, g_img, steps, n_bins, volume_filter,
            wrt=frozenset({"density"}), scatter_stride=scatter_stride,
            scatter_mode=scatter_mode,
            adj_in=adj_in, raw_adjoints=True,
            sample_volume_fn=slab_sampler, vol_scatter_fn=slab_scatter,
            vol_meta=((D + 1, H + 1, W + 1), "full"),
            pixel_grid=(sx, sy, seed_fn))
        g_raw = _contract_slab_adjoint(acc["g_vol"], D, H, W, slab_z)
        return state_out, image, g_raw

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(state_specs, ctx_specs, P(AXIS, None, None)),
        out_specs=(state_specs, P(AXIS, None, None), P(AXIS, None, None)),
        check_vma=False,
    )
    if lower_only:
        return jax.jit(fn).lower(state, ctx, g_image)
    state_out, image, g = jax.jit(fn)(state, ctx, g_image)
    return state_out, image, {"density": g[:D]}


def prb_window_grads_slab(state, ctx, mesh, volume_dims, seeds, g_image,
                          steps: int, n_bins: int,
                          volume_filter: str = "linear",
                          scatter_stride: int = 1,
                          scatter_mode: str = "stride",
                          lower_only: bool = False):
    """K-dispatch WINDOW packed-PRB density gradients with the volume
    slab-sharded — the multi-dispatch companion of ``prb_grads_slab`` and
    the slab analog of ``prb_render_and_grads_many(window=True)``: a
    phase-0 untaped forward (routed gathers) stacks each dispatch's start
    state and the window-final normalizer, then the reverse dispatch scan
    threads the deposit-cotangent carry across boundaries while the
    volume-adjoint scatters route to their slab owners; the packed
    adjoint stays (rows/n, width) per device for the WHOLE window and
    contracts distributively once at the end.

    ``seeds``: (K,) uint32 per-dispatch frame seeds (per-dispatch
    ctx.seed_bits is ignored, like render_many). Returns
    (state_f, image, {"density": raw grad}), allclose to the replicated
    prb_render_and_grads_many(window=True) gradient (tests/test_slab.py).
    """
    from vpt_tpu.kernels import spectral_backward as SB

    n = mesh.devices.size
    resolution = state.px.shape[-1]
    streams = state.px.shape[0] if state.px.ndim == 3 else 1
    D, H, W = volume_dims
    Dp_padded = ctx.density.shape[0]
    slab_z = Dp_padded // n
    rows_per_device = slab_z * (H + 1) * (W + 1)
    rows_local = resolution // n

    lane = P(AXIS, None) if streams == 1 else P(None, AXIS, None)
    binned = P(None, AXIS, None) if streams == 1 else P(None, None, AXIS, None)
    state_specs = M.SpectralState(
        px=lane, py=lane, pz=lane, dx=lane, dy=lane, dz=lane,
        bounces=lane, samples=lane, bin=lane, wavelength=lane,
        radiance=binned, transmittance=binned,
    )
    ctx_specs = M.SpectralCtx(
        inv_mvp=P(), seed_bits=P(), extinction=P(), blur=P(),
        max_bounces=P(), light_direction=P(),
        density=P(AXIS, None, None, None),
        material_tf=P(), light_spectrum=P(), boundaries=P(), bin_xyz=P(),
        environment=None if ctx.environment is None else P(),
        majorant=None if ctx.majorant is None else P(),
    )

    def shard_fn(state, ctx, seeds, g_img):
        me = jax.lax.axis_index(AXIS)
        shape = (rows_local, resolution) if streams == 1 else (
            streams, rows_local, resolution)
        iy_local = jax.lax.broadcasted_iota(jnp.uint32, shape, len(shape) - 2)
        ix = jax.lax.broadcasted_iota(jnp.uint32, shape, len(shape) - 1)
        iy = iy_local + me.astype(jnp.uint32) * jnp.uint32(rows_local)
        seed_iy = iy
        if streams > 1:
            s = jax.lax.broadcasted_iota(jnp.uint32, shape, 0)
            seed_iy = iy + s * jnp.uint32(resolution)
        sx, sy = geometry.screen_position(ix, iy, 1.0 / resolution)
        seed_fn = lambda bits: sampling.seed_state(ix, seed_iy, bits)

        def slab_sampler(density, u, v, w, mode="linear"):
            return _sample_volume_slab(
                density, u, v, w, rows_per_device, (D, H, W), mode)

        def slab_scatter(adj, idx, upd):
            return _distributed_scatter_add(adj, idx, upd, rows_per_device)

        hooks = dict(
            sample_volume_fn=slab_sampler, vol_scatter_fn=slab_scatter,
            vol_meta=((D + 1, H + 1, W + 1), "full"),
            pixel_grid=(sx, sy, seed_fn),
            vol_adj_rows=rows_per_device,
        )
        m_final, image, starts, state_f = SB._window_forward(
            state, ctx, seeds, steps, n_bins, volume_filter,
            with_states=True, hooks=hooks)
        acc = SB._prb_many_core(
            state, ctx, seeds, g_img, steps, n_bins, volume_filter,
            wrt=frozenset({"density"}), scatter_stride=scatter_stride,
            scatter_mode=scatter_mode,
            m_final=m_final, starts=starts, hooks=hooks, raw_adjoints=True)
        g_raw = _contract_slab_adjoint(acc["g_vol"], D, H, W, slab_z)
        return state_f, image, g_raw

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(state_specs, ctx_specs, P(), P(AXIS, None, None)),
        out_specs=(state_specs, P(AXIS, None, None), P(AXIS, None, None)),
        check_vma=False,
    )
    seeds = jnp.asarray(seeds, jnp.uint32)
    if lower_only:
        return jax.jit(fn).lower(state, ctx, seeds, g_image)
    state_f, image, g = jax.jit(fn)(state, ctx, seeds, g_image)
    return state_f, image, {"density": g[:D]}


def _pack_slab_rows(raw, lo, slab_z: int, D: int):
    """Build THIS device's slab of the packed corner table in-graph from
    the replicated raw (D, H, W) density — packed row z uses raw planes
    clip(z-1) and clip(z) (the edge-pad of pack_volume_corners) with
    both-sides xy edge padding; rows with z > D are the zero padding of
    pad_packed_for_slabs. Runs inside shard_map; the FULL packed table
    (8x raw bytes) is never materialized on any device — this is what
    makes the slab optimizer loop viable for volumes whose packed table
    exceeds device memory while the raw grid still fits replicated."""
    zs = lo + jnp.arange(slab_z, dtype=jnp.int32)
    p0 = jnp.take(raw, jnp.clip(zs - 1, 0, D - 1), axis=0)
    p1 = jnp.take(raw, jnp.clip(zs, 0, D - 1), axis=0)
    q0 = jnp.pad(p0, ((0, 0), (1, 1), (1, 1)), mode="edge")
    q1 = jnp.pad(p1, ((0, 0), (1, 1), (1, 1)), mode="edge")
    Hp, Wp = q0.shape[1] - 1, q0.shape[2] - 1

    def c(q, by, bx):
        return q[:, by:by + Hp, bx:bx + Wp]

    packed = jnp.stack(
        [c(q0, 0, 0), c(q0, 0, 1), c(q0, 1, 0), c(q0, 1, 1),
         c(q1, 0, 0), c(q1, 0, 1), c(q1, 1, 0), c(q1, 1, 1)], axis=-1)
    valid = (zs <= D)[:, None, None, None]
    return jnp.where(valid, packed, 0.0)


def make_spectral_prb_step_slab(optimizer, mesh, volume_dims, steps: int,
                                n_bins: int, resolution: int,
                                streams: int = 1,
                                scatter_stride: int = 1,
                                scatter_mode: str = "stride",
                                volume_filter: str = "linear",
                                grad_clip: float = 1e3,
                                n_slab_z: int | None = None):
    """Jitted Adam step recovering DENSITY through the slab-sharded window
    backward — fit_spectral's engine for volumes whose packed corner table
    exceeds one device's memory.

    Design (the documented choice): the raw density param and the optimizer
    state stay REPLICATED (a 512^3 raw grid is 512 MB — it is the 8x packed
    table that outgrows device memory); each step, every device packs ONLY
    ITS z-slab of the corner table in-graph (_pack_slab_rows) so the full
    packed table never exists anywhere, the K-dispatch window runs with
    routed distributed gathers, the per-step volume-adjoint scatters route
    to their slab owners, the packed->raw contraction is distributed, and
    the resulting z-sharded raw gradient is gathered back to the replicated
    param for the Adam update. A fully param-sharded variant (z-sharded raw
    + sharded Adam state) is the next step beyond if raw + moments ever
    exceed device memory; the gradient and contraction machinery here
    already supports it.

    Returns step(istate, state0, ctx, seeds, target) -> (istate, loss):
    ``ctx``: the renderer ctx with FUSED 18-wide TF (pack_tables including
    material_tf/light_spectrum) and ctx.density ignored (replaced by the
    param); ``state0`` row-sharded over the mesh; ``seeds``: (K,) uint32;
    ``target`` the (H, W, 3) HDR target (replicated; sharded row-wise
    in-graph). Gradient estimator: the window-exact packed-adjoint PRB
    (identical to prb_window_grads_slab, allclose to the replicated
    prb_loss_and_grads)."""
    from vpt_tpu.kernels import spectral_backward as SB
    from vpt_tpu.optim import InverseState, sanitize_grads
    import optax

    n = mesh.devices.size
    D, H, W = volume_dims
    Dp_padded = D + 1 + ((-(D + 1)) % n)
    slab_z = n_slab_z if n_slab_z is not None else Dp_padded // n
    rows_per_device = slab_z * (H + 1) * (W + 1)
    rows_local = resolution // n

    lane = P(AXIS, None) if streams == 1 else P(None, AXIS, None)
    binned = P(None, AXIS, None) if streams == 1 else P(None, None, AXIS, None)
    state_specs = M.SpectralState(
        px=lane, py=lane, pz=lane, dx=lane, dy=lane, dz=lane,
        bounces=lane, samples=lane, bin=lane, wavelength=lane,
        radiance=binned, transmittance=binned,
    )

    def ctx_specs(ctx):
        return M.SpectralCtx(
            inv_mvp=P(), seed_bits=P(), extinction=P(), blur=P(),
            max_bounces=P(), light_direction=P(),
            density=P(),  # the replicated RAW grid rides in ctx.density
            material_tf=P(), light_spectrum=P(), boundaries=P(), bin_xyz=P(),
            environment=None if ctx.environment is None else P(),
            majorant=None if ctx.majorant is None else P(),
        )

    def shard_fn(state, ctx, seeds, target):
        me = jax.lax.axis_index(AXIS)
        raw = ctx.density  # replicated (D, H, W)
        packed_slab = _pack_slab_rows(raw, me * slab_z, slab_z, D)
        ctx = ctx._replace(density=packed_slab)

        shape = (rows_local, resolution) if streams == 1 else (
            streams, rows_local, resolution)
        iy_local = jax.lax.broadcasted_iota(jnp.uint32, shape, len(shape) - 2)
        ix = jax.lax.broadcasted_iota(jnp.uint32, shape, len(shape) - 1)
        iy = iy_local + me.astype(jnp.uint32) * jnp.uint32(rows_local)
        seed_iy = iy
        if streams > 1:
            s = jax.lax.broadcasted_iota(jnp.uint32, shape, 0)
            seed_iy = iy + s * jnp.uint32(resolution)
        sx, sy = geometry.screen_position(ix, iy, 1.0 / resolution)
        seed_fn = lambda bits: sampling.seed_state(ix, seed_iy, bits)

        def slab_sampler(density, u, v, w, mode="linear"):
            return _sample_volume_slab(
                density, u, v, w, rows_per_device, (D, H, W), mode)

        def slab_scatter(adj, idx, upd):
            return _distributed_scatter_add(adj, idx, upd, rows_per_device)

        hooks = dict(
            sample_volume_fn=slab_sampler, vol_scatter_fn=slab_scatter,
            vol_meta=((D + 1, H + 1, W + 1), "full"),
            pixel_grid=(sx, sy, seed_fn),
            vol_adj_rows=rows_per_device,
        )
        m_final, image, starts, state_f = SB._window_forward(
            state, ctx, seeds, steps, n_bins, volume_filter,
            with_states=True, hooks=hooks)
        # local loss cotangent on this device's rows; the loss itself is
        # the psum of local squared-error sums over the global pixel count
        numel = jnp.float32(resolution * resolution * 3)
        g_img = 2.0 * (image - target) / numel
        loss = jax.lax.psum(jnp.sum((image - target) ** 2), AXIS) / numel
        acc = SB._prb_many_core(
            state, ctx, seeds, g_img, steps, n_bins, volume_filter,
            wrt=frozenset({"density"}), scatter_stride=scatter_stride,
            scatter_mode=scatter_mode,
            m_final=m_final, starts=starts, hooks=hooks, raw_adjoints=True)
        g_raw = _contract_slab_adjoint(acc["g_vol"], D, H, W, slab_z)
        return state_f, loss, g_raw

    @jax.jit
    def step(istate: "InverseState", state0, ctx, seeds, target):
        ctx = ctx._replace(density=istate.params["density"])
        state_f, loss, g_raw = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(state_specs, ctx_specs(ctx), P(), P(AXIS, None, None)),
            out_specs=(state_specs, P(), P(AXIS, None, None)),
            check_vma=False,
        )(state0, ctx, jnp.asarray(seeds, jnp.uint32), target)
        grads = {"density": g_raw[:D]}
        if grad_clip is not None:
            grads = sanitize_grads(grads, grad_clip)
        # gather the z-sharded gradient to the replicated param layout for
        # the Adam update (the documented replicated-param design)
        grads = jax.lax.with_sharding_constraint(
            grads, {"density": NamedSharding(mesh, P())})
        updates, opt_state = optimizer.update(grads, istate.opt_state,
                                              istate.params)
        params = optax.apply_updates(istate.params, updates)
        params = dict(params, density=jnp.clip(params["density"], 0.0, 1.0))
        return InverseState(params, opt_state, istate.step + 1), loss

    return step


def fit_spectral_slab(target_image, renderer, camera, init_density, mesh,
                      dispatches_per_step: int = 8, iterations: int = 50,
                      learning_rate: float = 0.02, seed: int = 0,
                      scatter_stride: int = 1, scatter_mode: str = "stride",
                      progress=None):
    """End-to-end slab-sharded density recovery: like
    optim.fit_spectral(method="prb", wrt={"density"}) but with the volume
    slab-sharded over ``mesh`` for packed tables larger than one device's
    memory.

    ``renderer``: an MCMSpectralRenderer built with
    pack_tables={"material_tf", "light_spectrum"} (fused TF, RAW density
    — the slab step packs per-device slabs in-graph) and mesh=mesh.
    Returns (params, losses)."""
    import numpy as np
    import optax

    from vpt_tpu.optim import InverseState

    base_ctx = renderer.ctx(camera, seed)
    assert base_ctx.material_tf.shape[-1] == 18, (
        "fit_spectral_slab needs the fused TF "
        "(pack_tables={'material_tf','light_spectrum'})")
    state0 = renderer.reset(camera, seed)
    steps = renderer.config.steps
    n_bins = renderer.spectrum.n_bins
    D, H, W = np.asarray(init_density).shape

    params = {"density": jnp.asarray(init_density)}
    optimizer = optax.adam(learning_rate)
    # placed as the step returns it (replicated over the mesh), so the
    # second step does not recompile for a new input sharding
    istate = jax.device_put(
        InverseState(params, optimizer.init(params),
                     jnp.zeros((), jnp.int32)),
        NamedSharding(mesh, P()))
    step = make_spectral_prb_step_slab(
        optimizer, mesh, (D, H, W), steps, n_bins, renderer.resolution,
        streams=renderer.streams, scatter_stride=scatter_stride,
        scatter_mode=scatter_mode,
        volume_filter=renderer.volume.filter)

    target = jnp.asarray(target_image)
    losses = []
    for i in range(iterations):
        seeds = jnp.asarray(
            [np.uint32((seed + 1 + i * dispatches_per_step + k)
                       * 2654435761 % 2**32)
             for k in range(dispatches_per_step)], jnp.uint32)
        istate, loss = step(istate, state0, base_ctx, seeds, target)
        losses.append(float(loss))
        if progress is not None and (i % 10 == 0 or i == iterations - 1):
            progress(i, losses[-1])
    return istate.params, losses


def render_slab(state, ctx, mesh, volume_dims, steps: int, n_bins: int,
                volume_filter: str = "linear", lower_only: bool = False):
    """One spectral render dispatch with the volume slab-sharded.

    ``ctx.density`` must be the slab-sharded padded packed table
    (shard_packed_volume); ``volume_dims`` the original (D, H, W).
    State lanes shard over rows as usual. Returns (state, image) —
    bit-identical to M.render with a replicated volume.

    ``lower_only``: return the lowered-but-unexecuted program instead
    (tests/test_hlo.py inspects its compiled HLO for the two-collective
    contract).
    """
    n = mesh.devices.size
    resolution = state.px.shape[-1]
    streams = state.px.shape[0] if state.px.ndim == 3 else 1
    D, H, W = volume_dims
    Dp_padded = ctx.density.shape[0]
    rows_per_device = (Dp_padded // n) * (H + 1) * (W + 1)

    # lane leaves are (H, W) or — with sample streams — (S, H, W); the
    # framebuffer H axis shards over "rays" either way (streams replicate:
    # they are per-pixel, not per-device)
    lane = P(AXIS, None) if streams == 1 else P(None, AXIS, None)
    binned = P(None, AXIS, None) if streams == 1 else P(None, None, AXIS, None)
    state_specs = M.SpectralState(
        px=lane, py=lane, pz=lane, dx=lane, dy=lane, dz=lane,
        bounces=lane, samples=lane, bin=lane, wavelength=lane,
        radiance=binned, transmittance=binned,
    )
    ctx_specs = M.SpectralCtx(
        inv_mvp=P(), seed_bits=P(), extinction=P(), blur=P(),
        max_bounces=P(), light_direction=P(),
        density=P(AXIS, None, None, None),
        material_tf=P(), light_spectrum=P(), boundaries=P(), bin_xyz=P(),
        environment=None if ctx.environment is None else P(),
        majorant=None if ctx.majorant is None else P(),
    )

    rows_local = resolution // n

    def shard_fn(state, ctx):
        me = jax.lax.axis_index(AXIS)
        # global pixel coordinates for this device's row shard (streams seed
        # as extra framebuffer rows, exactly like _pixel_grid)
        shape = (rows_local, resolution) if streams == 1 else (
            streams, rows_local, resolution
        )
        iy_local = jax.lax.broadcasted_iota(jnp.uint32, shape, len(shape) - 2)
        ix = jax.lax.broadcasted_iota(jnp.uint32, shape, len(shape) - 1)
        iy = iy_local + me.astype(jnp.uint32) * jnp.uint32(rows_local)
        seed_iy = iy
        if streams > 1:
            s = jax.lax.broadcasted_iota(jnp.uint32, shape, 0)
            seed_iy = iy + s * jnp.uint32(resolution)
        sx, sy = geometry.screen_position(ix, iy, 1.0 / resolution)
        rng = sampling.seed_state(ix, seed_iy, ctx.seed_bits)

        def slab_sampler(density, u, v, w, mode="linear"):
            return _sample_volume_slab(
                density, u, v, w, rows_per_device, (D, H, W), mode
            )

        def body(_, carry):
            p, r = carry
            p, r, _ = M._render_body(p, r, None, sx, sy, ctx, n_bins,
                                     volume_filter, diff=False,
                                     sample_volume_fn=slab_sampler)
            return (p, r)

        state, rng = jax.lax.fori_loop(0, steps, body, (state, rng))
        image = M.radiance_to_rgb(state.radiance, ctx.bin_xyz)
        return state, image

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(state_specs, ctx_specs),
        out_specs=(state_specs, P(AXIS, None, None)),
        check_vma=False,
    )
    if lower_only:
        return jax.jit(fn).lower(state, ctx)
    return jax.jit(fn)(state, ctx)
