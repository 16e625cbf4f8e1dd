"""Hand-derived backward pass for the spectral MCM renderer — path replay
(radiative-backprop / PRB style), no autodiff tape.

The estimator: a sample terminates with deposit c = emitted(light) after a
sequence of events drawn with probabilities P_e(theta). The gradient of the
expected image w.r.t. theta is

    E[ cbar * ( d(emitted)/d(theta)  +  emitted * sum_e dlog P_e/d(theta) ) ]

with cbar the image cotangent of that deposit (1/M_final per deposit in the
incremental mean). All terms are *local to an event* once the sample's
eventual contribution is known, so the backward is:

  pass 1 (tape):   forward dispatch recording per-step (emitted, respawn,
                   bin) — a (steps, lanes) tape, ~KBs per megapixel
  reverse scan:    propagate each step's *active-sample* contribution
                   backward (c_active), turning future deposits into
                   per-step locals
  pass 2 (replay): re-run the dispatch (same RNG chains), and at each step
                   scatter the analytic score/pathwise terms:

    null:     d log(1-alpha)            = -1/(1-alpha)            -> alpha
    scatter:  d log(alpha*albedo)       = 1/alpha, 1/albedo       -> alpha, albedo
              d log p_HG(cos; g)        = -2g/(1-g^2)
                                          - 3(g-cos)/(1+g^2-2g cos) -> g
    flight:   d log(mu e^(-mu d))       = 1/mu - d                -> extinction
    escape:   d emitted / d light-texel (pathwise, 5x lerp)       -> spectrum
    TF chain: d value/d density = 256*(row1-row0) (bilinear slope)
              -> trilinear-scattered into the 8 volume corners

Gradients are mathematically equal in expectation to the autodiff REINFORCE
surrogate (models/mcm_spectral.render_diff) — the discrete-event terms are
identical; the free-flight and HG terms use the score form where autodiff
uses the reparameterized (pathwise) form, so per-seed values differ but
means agree (tested). Memory is O(steps x lanes) scalars instead of full
autodiff residuals, and the backward is two forward passes plus one scatter
per table per step.

Gradients address the *raw* (unpacked) density / TF / spectrum tables
(build the renderer with pack_tables=False). Like the autodiff path, the
estimator is truncated to the dispatch window (events of samples begun in
earlier dispatches are attributed from this window on).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from vpt_tpu.models import mcm_spectral as M
from vpt_tpu.ops import geometry, interp, sampling
from vpt_tpu.ops.spectral import XYZ_TO_SRGB_KERNEL

EPS = 1e-5


def _bilinear_corners(u, v, H, W):
    """Corner indices + weights of sample_tex2d's bilinear lookup."""

    def coords(t, n):
        s = t * n - 0.5
        base = jnp.floor(s).astype(jnp.int32)
        frac = s - base.astype(jnp.float32)
        return jnp.clip(base, 0, n - 1), jnp.clip(base + 1, 0, n - 1), frac

    x0, x1, fx = coords(u, W)
    y0, y1, fy = coords(v, H)
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    return (y0, y1, x0, x1), (w00, w01, w10, w11), (fx, fy)


def _trilinear_corners(u, v, w, D, H, W, volume_filter="linear"):
    def coords(t, n):
        s = t * n - 0.5
        base = jnp.floor(s).astype(jnp.int32)
        frac = s - base.astype(jnp.float32)
        return jnp.clip(base, 0, n - 1), jnp.clip(base + 1, 0, n - 1), frac

    x0, x1, fx = coords(u, W)
    y0, y1, fy = coords(v, H)
    z0, z1, fz = coords(w, D)
    if volume_filter == "quasicubic":
        # d(sample)/d(corner) under the smoothstep warp is the WARPED
        # weight (positions are detached in the replay backward, so the
        # 6f(1-f) position-chain factor never appears) — matches
        # interp.sample_volume's forward warp exactly
        fx = fx * fx * (3.0 - 2.0 * fx)
        fy = fy * fy * (3.0 - 2.0 * fy)
        fz = fz * fz * (3.0 - 2.0 * fz)
    idx = []
    wts = []
    for zi, wz in ((z0, 1 - fz), (z1, fz)):
        for yi, wy in ((y0, 1 - fy), (y1, fy)):
            for xi, wx in ((x0, 1 - fx), (x1, fx)):
                idx.append((zi * H + yi) * W + xi)
                wts.append(wz * wy * wx)
    return idx, wts


def _tf_row_slope(tf_table, t, dens, channel):
    """d(bilinear TF value)/d(density coordinate) for one channel:
    256 * (x-lerped row1 - row0); zero automatically in the clamp zone."""
    H, W, _ = tf_table.shape
    (y0, y1, x0, x1), _, (fx, _) = _bilinear_corners(t, dens, H, W)
    flat = tf_table[..., channel].reshape(-1)
    c00 = jnp.take(flat, y0 * W + x0)
    c01 = jnp.take(flat, y0 * W + x1)
    c10 = jnp.take(flat, y1 * W + x0)
    c11 = jnp.take(flat, y1 * W + x1)
    r0 = c00 + (c01 - c00) * fx
    r1 = c10 + (c11 - c10) * fx
    return (r1 - r0) * H


def spectral_backward(state0, ctx, g_image, steps: int, n_bins: int,
                      volume_filter: str = "linear"):
    """Hand-derived gradients of one render dispatch.

    Returns (state_out, image, grads) where grads =
    dict(density, material_tf, light_spectrum, extinction) — the cotangents
    of ``radiance_to_rgb(dispatch(state0, ctx))`` contracted with
    ``g_image`` ((H, W, 3)).
    """
    assert ctx.environment is None, (
        "the raw replay backward does not support environment maps; use the "
        "packed path (pack_tables=True), which carries env-texel gradients")
    resolution = state0.px.shape[-1]
    streams = state0.px.shape[0] if state0.px.ndim == 3 else 1
    ix, iy, seed_iy = M._pixel_grid(resolution, streams)
    sx, sy = geometry.screen_position(ix, iy, 1.0 / resolution)
    rng0 = sampling.seed_state(ix, seed_iy, ctx.seed_bits)

    # ---- pass 1: forward with a compact tape -----------------------------
    def fwd_body(carry, _):
        p, rng = carry
        p, rng, _, internals = M._render_body(
            p, rng, None, sx, sy, ctx, n_bins, volume_filter,
            diff=False, collect=True,
        )
        tape = dict(
            emitted=internals["emitted"],
            respawn=internals["respawn"],
            pre_bin=internals["pre_bin"],
        )
        return (p, rng), tape

    (state_out, _), tape = jax.lax.scan(fwd_body, (state0, rng0), None, length=steps)

    # ---- image cotangent -> per-deposit cotangent ------------------------
    # image = (mean over streams of) einsum(radiance, bin_xyz) @ M^T
    cm = jnp.matmul(jnp.asarray(XYZ_TO_SRGB_KERNEL), ctx.bin_xyz,
                    precision=jax.lax.Precision.HIGHEST)  # (3, B)
    g_rad = jnp.einsum("hwc,cb->bhw", g_image, cm,
                       precision=jax.lax.Precision.HIGHEST)  # (B, H, W)
    if streams > 1:
        # broadcast from g_rad's own pixel dims, not (resolution,
        # resolution): inside shard_map the rows axis is the LOCAL shard
        g_rad = jnp.broadcast_to(
            g_rad[:, None] / streams, (n_bins, streams) + g_rad.shape[1:]
        )
    m_final = jnp.maximum(state_out.samples, 1).astype(jnp.float32)

    def deposit_cotangent(pre_bin):
        # cbar = g_rad[bin] / M_final for the depositing lane
        sel = jnp.take_along_axis(
            g_rad.reshape(n_bins, -1), pre_bin.reshape(1, -1), axis=0
        ).reshape(pre_bin.shape)
        return sel / m_final

    # ---- reverse scan: contribution of the step's active sample ----------
    def rev_body(carry, t):
        c_next, cb_next = carry
        dep = t["respawn"]
        c = jnp.where(dep, t["emitted"], c_next)
        cb = jnp.where(dep, deposit_cotangent(t["pre_bin"]), cb_next)
        return (c, cb), (c, cb)

    zero = jnp.zeros_like(tape["emitted"][0])
    (_, _), (c_act, cb_act) = jax.lax.scan(
        rev_body, (zero, zero), tape, reverse=True
    )

    # ---- pass 2: replay + analytic scatters ------------------------------
    D, H, W = ctx.density.shape
    TH, TW, TC = ctx.material_tf.shape
    (LN,) = ctx.light_spectrum.shape

    def rep_body(carry, inputs):
        (p, rng, g_dens, g_tf, g_ls, g_ext) = carry
        c, cb = inputs
        p2, rng2, _, it = M._render_body(
            p, rng, None, sx, sy, ctx, n_bins, volume_filter,
            diff=False, collect=True,
        )
        q = cb * c  # cbar * eventual contribution of the active sample

        alpha = it["alpha"]
        albedo = it["albedo"]
        g = it["g"]
        null = it["null"]
        scat = it["scatter"]
        oob = it["oob"]
        dens = it["dens"]
        t_lam = (it["pre_wavelength"] - 400.0) / 300.0

        # per-channel value gradients from the event scores
        grad_alpha = (
            jnp.where(null, -q / jnp.maximum(1.0 - alpha, 1e-12), 0.0)
            + jnp.where(scat, q / jnp.maximum(alpha, 1e-12), 0.0)
        )
        grad_albedo = jnp.where(scat, q / jnp.maximum(albedo, 1e-12), 0.0)
        aniso = jnp.abs(g) >= EPS
        cosd = it["hg_cos"]
        g2 = g * g
        hg_score = -2.0 * g / jnp.maximum(1.0 - g2, 1e-9) - 3.0 * (g - cosd) / jnp.maximum(
            1.0 + g2 - 2.0 * g * cosd, 1e-9
        )
        grad_graw = jnp.where(scat & aniso, q * hg_score, 0.0) * 2.0  # g = 2*raw-1

        # extinction score: every step's free-flight draw of a contributing
        # sample (1/mu - dist)
        g_ext = g_ext + jnp.sum(q * (1.0 / ctx.extinction - it["dist"]))

        # light spectrum (pathwise at escape)
        ld = ctx.light_direction
        lnorm = jnp.sqrt(jnp.sum(ld * ld))
        ldn = ld / jnp.maximum(lnorm, 1e-30)
        ddot = (
            it["pre_dir"][0] * ldn[0]
            + it["pre_dir"][1] * ldn[1]
            + it["pre_dir"][2] * ldn[2]
        )
        dI = jnp.where(lnorm < EPS, 1.0, jnp.where(it["emitted"] > 0.0, ddot, 0.0))
        gl = jnp.where(oob, cb * dI * 5.0, 0.0)
        tl = t_lam * LN - 0.5
        l0 = jnp.clip(jnp.floor(tl).astype(jnp.int32), 0, LN - 1)
        l1 = jnp.clip(jnp.floor(tl).astype(jnp.int32) + 1, 0, LN - 1)
        lf = tl - jnp.floor(tl)
        g_ls = g_ls.at[l0.reshape(-1)].add((gl * (1 - lf)).reshape(-1))
        g_ls = g_ls.at[l1.reshape(-1)].add((gl * lf).reshape(-1))

        # TF texel scatters (one flat scatter for all corners x channels)
        (y0, y1, x0, x1), (w00, w01, w10, w11), _ = _bilinear_corners(
            t_lam, dens, TH, TW
        )
        tf_idx = []
        tf_val = []
        for ch, gval in ((0, grad_albedo), (1, grad_alpha), (2, grad_graw)):
            for yi, xi, wcorner in ((y0, x0, w00), (y0, x1, w01),
                                    (y1, x0, w10), (y1, x1, w11)):
                tf_idx.append(((yi * TW + xi) * TC + ch).reshape(-1))
                tf_val.append((gval * wcorner).reshape(-1))
        g_tf = g_tf.at[jnp.concatenate(tf_idx)].add(jnp.concatenate(tf_val))

        # density chain: sum of channel slopes, trilinear-scattered
        grad_dens = (
            grad_albedo * _tf_row_slope(ctx.material_tf, t_lam, dens, 0)
            + grad_alpha * _tf_row_slope(ctx.material_tf, t_lam, dens, 1)
            + grad_graw * _tf_row_slope(ctx.material_tf, t_lam, dens, 2)
        )
        u, v, w = it["sample_pos"]
        v_idx, v_wts = _trilinear_corners(u, v, w, D, H, W, volume_filter)
        g_dens = g_dens.at[jnp.concatenate([i.reshape(-1) for i in v_idx])].add(
            jnp.concatenate([(grad_dens * wt).reshape(-1) for wt in v_wts])
        )

        return (p2, rng2, g_dens, g_tf, g_ls, g_ext), None

    g_dens0 = jnp.zeros(D * H * W, jnp.float32)
    g_tf0 = jnp.zeros(TH * TW * TC, jnp.float32)
    g_ls0 = jnp.zeros(LN, jnp.float32)
    (_, _, g_dens, g_tf, g_ls, g_ext), _ = jax.lax.scan(
        rep_body, (state0, rng0, g_dens0, g_tf0, g_ls0, jnp.float32(0.0)),
        (c_act, cb_act),
    )
    grads = dict(
        density=g_dens.reshape(D, H, W),
        material_tf=g_tf.reshape(TH, TW, TC),
        light_spectrum=g_ls,
        extinction=g_ext,
    )
    image = M.radiance_to_rgb(state_out.radiance, ctx.bin_xyz)
    return state_out, image, grads


# ==========================================================================
# Packed-adjoint backward (the fast path)
# ==========================================================================
#
# The raw backward above replays the dispatch and scatters every gradient
# into the *raw* tables: 12 TF-corner x channel indices + 8 volume corners +
# 2 light texels per lane per step, plus 12 slope gathers. The packed variant
# applies the forward path's corner-packing playbook to the adjoint:
# gradients scatter as ONE contiguous row per table per lane (an 18-wide
# TF+light row, an 8-wide trilinear row) into adjoints shaped like the
# packed tables, which are then contracted back to the raw parameterization
# with the dense transpose of the packers (jax.vjp of
# ops/interp.pack_*_jnp — pad/stack transposes, no scatters). The analytic
# scatters fold into the cotangent reverse scan over a compact tape, so a
# full fwd+bwd dispatch is one taped forward + one reverse scan — ~4 index
# ops per lane-step vs the raw path's ~36.

ALL_WRT = frozenset({"density", "material_tf", "light_spectrum", "extinction"})


def _packed_base_frac(t, n):
    """Packed-table addressing (mirrors interp._sample_volume_packed):
    +1 into the padded table, clamp to [0, n], frac in [0, 1)."""
    s = t * n - 0.5
    i0 = jnp.floor(s)
    return jnp.clip(i0.astype(jnp.int32) + 1, 0, n), s - i0


def _packed_vol_meta(ctx):
    """(vol_dims, vol_kind) of the ctx's packed volume representation."""
    if isinstance(ctx.density, interp.PackedVolume):
        return ctx.density.dims, ctx.density.kind
    assert ctx.density.ndim == 4, "packed backward needs a packed volume"
    return ctx.density.shape[:3], ("xy" if ctx.density.shape[-1] == 4 else "full")


def _packed_adj_init(ctx, wrt: frozenset, vol_meta=None, vol_adj_rows=None):
    """Zero packed-adjoint accumulators for the given ``wrt`` subset (the
    scan carry of the multi-dispatch backward). ``vol_meta`` /
    ``vol_adj_rows`` override the volume-adjoint sizing for callers whose
    ctx.density is not self-describing (the slab wrapper: global packed
    dims + a per-device local row count)."""
    import numpy as np

    adj = {}
    if "extinction" in wrt:
        adj["g_ext"] = jnp.float32(0.0)
    if "material_tf" in wrt or "light_spectrum" in wrt:
        Hp, Wp, CC = ctx.material_tf.shape
        adj["g_tf"] = jnp.zeros((Hp * Wp, CC), jnp.float32)
    if "density" in wrt:
        vol_dims, vol_kind = vol_meta if vol_meta is not None \
            else _packed_vol_meta(ctx)
        rows = (vol_adj_rows if vol_adj_rows is not None
                else int(np.prod(vol_dims)))
        adj["g_vol"] = jnp.zeros(
            (rows, 4 if vol_kind == "xy" else 8), jnp.float32)
    if "environment" in wrt and ctx.environment is not None:
        HpE, WpE, _ = ctx.environment.shape
        adj["g_env"] = jnp.zeros((HpE * WpE, 12), jnp.float32)
    return adj


def _contract_packed_adjoints(acc, ctx, wrt: frozenset):
    """Packed adjoints -> gradients addressing the RAW tables, via the dense
    transposes of the packers (jax.vjp of ops/interp.pack_*_jnp)."""
    grads = {}
    if "extinction" in wrt:
        grads["extinction"] = acc["g_ext"]
    if "material_tf" in wrt or "light_spectrum" in wrt:
        Hp, Wp, CC = ctx.material_tf.shape
        TH, TW = Hp - 1, Wp - 1
        g_tf = acc["g_tf"].reshape(Hp, Wp, CC)
        if "material_tf" in wrt:
            _, vjp_tf = jax.vjp(interp.pack_tex2d_corners_jnp,
                                jnp.zeros((TH, TW, 4), jnp.float32))
            (grads["material_tf"],) = vjp_tf(g_tf[..., :16])
        if "light_spectrum" in wrt:
            # light pair was broadcast over TF rows -> transpose = row sum
            _, vjp_ls = jax.vjp(interp.pack_tex1d_corners_jnp,
                                jnp.zeros((TW,), jnp.float32))
            (grads["light_spectrum"],) = vjp_ls(jnp.sum(g_tf[..., 16:], axis=0))
    if "density" in wrt:
        vol_dims, vol_kind = _packed_vol_meta(ctx)
        if vol_kind == "xy":
            VD, VHp, VWp = vol_dims
            raw_shape = (VD, VHp - 1, VWp - 1)
            _, vjp_vol = jax.vjp(interp.pack_volume_corners_xy_jnp,
                                 jnp.zeros(raw_shape, jnp.float32))
            width = 4
        else:
            VDp, VHp, VWp = vol_dims
            raw_shape = (VDp - 1, VHp - 1, VWp - 1)
            _, vjp_vol = jax.vjp(interp.pack_volume_corners_jnp,
                                 jnp.zeros(raw_shape, jnp.float32))
            width = 8
        (grads["density"],) = vjp_vol(
            acc["g_vol"].reshape(tuple(vol_dims) + (width,)))
    if "environment" in wrt and ctx.environment is not None:
        HpE, WpE, _ = ctx.environment.shape
        _, vjp_env = jax.vjp(interp.pack_tex2d_corners_jnp,
                             jnp.zeros((HpE - 1, WpE - 1, 3), jnp.float32))
        (grads["environment"],) = vjp_env(acc["g_env"].reshape(HpE, WpE, 12))
    return grads


def _bitcast_f(x):
    """int32/bool -> f32 bit pattern (packed-tape slot encoding)."""
    if x.dtype == jnp.bool_:
        return x.astype(jnp.float32)
    if x.dtype == jnp.int32:
        return jax.lax.bitcast_convert_type(x, jnp.float32)
    return x


def _bitcast_i(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _importance_metric(tape, c_all, cb_all, want_vol, want_tf, want_env):
    """Per-step selection weight for importance thinning: the SUM of the
    absolute scatter magnitudes this step would emit into every active
    table — computed elementwise from the tape BEFORE selection (the same
    formulas scatter_step uses). Correctness: a positive-combination
    metric is a valid importance distribution for every table exactly
    when it is nonzero wherever that table's scatter value is nonzero;
    summing each table's own |value| guarantees that per construction.
    (A plain |q| = |c*cb| metric is NOT valid for the light/env terms —
    their scatters scale with cb alone, so a zero-contribution escaping
    path still carries light gradient — and it wastes picks on steps
    whose TF slope is zero, which is most steps in sparse-gradient
    scenes: the regime this mode exists for.)"""
    q = c_all * cb_all
    alpha, albedo, g = tape["alpha"], tape["albedo"], tape["g"]
    null, scat = tape["null"], tape["scatter"]
    grad_alpha = (
        jnp.where(null, -q / jnp.maximum(1.0 - alpha, 1e-12), 0.0)
        + jnp.where(scat, q / jnp.maximum(alpha, 1e-12), 0.0))
    grad_albedo = jnp.where(scat, q / jnp.maximum(albedo, 1e-12), 0.0)
    aniso = jnp.abs(g) >= EPS
    cosd = tape["hg_cos"]
    g2 = g * g
    hg_score = (-2.0 * g / jnp.maximum(1.0 - g2, 1e-9)
                - 3.0 * (g - cosd)
                / jnp.maximum(1.0 + g2 - 2.0 * g * cosd, 1e-9))
    grad_graw = jnp.where(scat & aniso, q * hg_score, 0.0) * 2.0
    metric = jnp.zeros_like(q)
    if want_vol:
        s = tape["slopes"]
        metric = metric + jnp.abs(grad_albedo * s[..., 0]
                                  + grad_alpha * s[..., 1]
                                  + grad_graw * s[..., 2])
    if want_tf:
        metric = metric + (jnp.abs(grad_albedo) + jnp.abs(grad_alpha)
                           + jnp.abs(grad_graw)
                           + jnp.abs(cb_all * tape["light_w"]))
    if want_env:
        metric = metric + jnp.abs(cb_all * tape["env_w"])
    return metric


def _importance_scatter(adj0, tape, c_all, cb_all, picks: int, pick_state,
                        scatter_step, steps: int,
                        want_vol=True, want_tf=False, want_env=False):
    """Importance-thinned table scatters: instead of the
    uniform stride phase, each lane samples ``picks`` step indices i.i.d.
    with probability proportional to the step's actual total scatter
    magnitude (_importance_metric), and scatters those steps reweighted
    by S / (picks * metric_sel). Unbiased per table because the metric is
    positive wherever that table's scatter value is nonzero (standard
    importance sampling of a finite sum); variance concentrates the same
    scatter-index budget where the gradient mass is — the regime where
    uniform stride thinning fails (sparse-gradient scenes,
    tools/convergence_stride.py).

    Mechanics: the per-step tape fields a scatter needs are pre-packed
    into ONE (steps * lanes, C) row table (ints/bools bit-cast into f32
    slots), so each pick costs a single row gather per lane (the forward's
    corner-packing trick applied to the tape) plus the same per-table
    scatters a stride step would issue.
    """
    from vpt_tpu.ops import sampling

    lane_shape = c_all.shape[1:]
    L = int(np.prod(lane_shape))

    absq = _importance_metric(tape, c_all, cb_all, want_vol, want_tf,
                              want_env)
    S = jnp.sum(absq, axis=0)
    p = absq / jnp.maximum(S, 1e-30)[None]
    cdf = jnp.cumsum(p, axis=0)

    # pack every tape field (plus c, cb, absq) into one row per lane-step;
    # multi-component fields (e.g. slopes (..., 3)) take one slot per
    # component, int/bool fields are bit-cast/encoded into f32 slots
    fields = sorted(tape.keys())
    cols, spec = [], []
    base_ndim = c_all.ndim
    for k in fields:
        v = tape[k]
        if v.ndim == base_ndim + 1:
            for ci in range(v.shape[-1]):
                cols.append(_bitcast_f(v[..., ci]))
                spec.append((k, ci, v.dtype))
        else:
            cols.append(_bitcast_f(v))
            spec.append((k, None, v.dtype))
    n_field_cols = len(cols)
    cols += [c_all, cb_all, absq]
    packed = jnp.stack(cols, axis=-1).reshape(steps * L, len(cols))

    # pick_state: per-lane uint32 seeded from GLOBAL lane identity (pixel
    # coords + stream row + pick_bits) so importance selection — like every
    # other random draw in the build — is bit-identical across mesh shapes
    adj = adj0
    for j in range(picks):
        state = sampling.pcg_hash(
            pick_state ^ (jnp.uint32(0x9E3779B9) * jnp.uint32(j + 1)))
        u = sampling.uniform_from_state(state)
        sel = jnp.sum((cdf < u[None]).astype(jnp.int32), axis=0)
        sel = jnp.clip(sel, 0, steps - 1)
        rows = jnp.take(packed, (sel.reshape(-1) * L
                                 + jnp.arange(L, dtype=jnp.int32)), axis=0)
        rows = rows.reshape(lane_shape + (len(cols),))
        parts = {}
        for i, (k, ci, dt) in enumerate(spec):
            v = rows[..., i]
            if dt == jnp.bool_:
                v = v > 0.5
            elif dt == jnp.int32:
                v = _bitcast_i(v)
            parts.setdefault(k, {})[ci] = v
        t_sel = {}
        for k, comps in parts.items():
            if list(comps.keys()) == [None]:
                t_sel[k] = comps[None]
            else:
                t_sel[k] = jnp.stack(
                    [comps[ci] for ci in sorted(comps)], axis=-1)
        # slot layout: field components..., c, cb, absq
        c_sel = rows[..., n_field_cols]
        cb_sel = rows[..., n_field_cols + 1]
        absq_sel = rows[..., n_field_cols + 2]
        w = jnp.where(absq_sel > 0.0,
                      S / (jnp.float32(picks) * jnp.maximum(absq_sel, 1e-30)),
                      0.0)
        adj = scatter_step(adj, t_sel, c_sel, cb_sel, weight=w)
    return adj


def spectral_backward_packed(state0, ctx, g_image, steps: int, n_bins: int,
                             volume_filter: str = "linear",
                             wrt: frozenset = ALL_WRT,
                             scatter_stride: int = 1,
                             scatter_mode: str = "stride",
                             pick_bits=None,
                             scatter_phase=None,
                             m_final=None,
                             adj_in=None,
                             raw_adjoints: bool = False,
                             cot_in=None,
                             return_cot: bool = False,
                             forward_only: bool = False,
                             tape_in=None,
                             state_out_in=None,
                             sample_volume_fn=None,
                             vol_scatter_fn=None,
                             vol_meta=None,
                             pixel_grid=None):
    """Hand-derived gradients of one render dispatch — packed tables.

    Requires the standard fast-path ctx: fused (H+1, W+1, 18) material TF
    (pack_tex2d_with_tex1d) and a packed volume (full 8-wide corner table
    or the xy half-packed 4-wide big-volume table). Returns
    (state_out, image, grads) with grads addressing the RAW tables —
    mathematically identical to ``spectral_backward`` on the unpacked ctx.

    ``wrt``: which parameters to differentiate. Each table skipped drops
    its scatters — e.g. inverse rendering of density only skips the TF
    row scatter entirely.

    ``scatter_stride``: k > 1 enables stochastic gradient thinning — only
    every k-th step's TABLE contributions are scattered, weighted by k
    (an unbiased estimator of the same gradient with ~k x the table-grad
    variance; the phase rotates with the frame seed so strides cover all
    steps across dispatches). The forward image, the extinction gradient,
    and the cotangent propagation stay exact. Scatter indices are the
    backward's wall (per-INDEX cost, measured), so the backward speeds up
    near-proportionally.

    Multi-dispatch plumbing (prb_render_and_grads_many):
    ``m_final`` overrides the deposit-cotangent normalizer (the sample
    counts at the end of the WHOLE dispatch window rather than this
    dispatch — matching the autodiff surrogate's incremental-mean
    cotangents, where every deposit's weight is 1/M_window_end);
    ``adj_in`` seeds the packed-adjoint accumulators (scan carry);
    ``raw_adjoints`` returns (state_out, image, acc) with the packed
    adjoints uncontracted so a scan can accumulate across dispatches and
    contract once. ``cot_in``/``return_cot`` thread the per-lane deposit
    cotangent carry {c, cb} ACROSS dispatch boundaries: a path alive at
    this dispatch's end deposits in a LATER dispatch, and its steps here
    must credit that deposit's (contribution, cotangent) — the window
    backward runs dispatches in reverse order passing each dispatch's
    start-of-dispatch carry into the previous one. Without threading,
    score chains truncate at dispatch boundaries (at extinction ~40 paths
    span many 8-step dispatches, so most credit is dropped — measured
    corr ~0.1 against the autodiff window gradient).

    ``forward_only=True`` runs just the taped forward and returns
    (state_out, tape); ``tape_in``/``state_out_in`` skip the forward and
    run the reverse pass on the stored tape — together they let a window
    backward tape all K dispatches in ONE forward sweep (window_storage=
    "tape") instead of simulating twice (untaped phase-0 for start states
    + per-dispatch taped re-simulate).
    """
    assert ctx.material_tf.shape[-1] == 18, "packed backward needs the fused TF"
    assert volume_filter in ("linear", "quasicubic"), (
        "packed backward supports linear/quasicubic filtering")
    env_mode = ctx.environment is not None
    want_env = env_mode and "environment" in wrt
    if want_env:
        assert ctx.environment.shape[-1] == 12, (
            "environment gradients need the packed equirect table "
            "(pack_tex2d_corners; renderer pack_tables including material_tf)")

    # the packed volume arrives either as a flat PackedVolume (large tables)
    # or the natural 4-D array (small tables — interp.pack_volume_auto);
    # the backward only needs the padded dims + kind, and its adjoint is
    # flat (rows, width) in both cases. ``vol_meta`` overrides both for
    # callers whose ctx.density is not self-describing — the slab-sharded
    # wrapper (parallel/slab.py) passes the GLOBAL packed dims while
    # ctx.density inside shard_map is one local z-slab.
    vol_dims, vol_kind = vol_meta if vol_meta is not None \
        else _packed_vol_meta(ctx)

    resolution = state0.px.shape[-1]
    streams = state0.px.shape[0] if state0.px.ndim == 3 else 1
    if pixel_grid is None:
        ix, iy, seed_iy = M._pixel_grid(resolution, streams)
        sx, sy = geometry.screen_position(ix, iy, 1.0 / resolution)
        rng0 = sampling.seed_state(ix, seed_iy, ctx.seed_bits)
    else:
        # slab wrapper: this device's global pixel coords + a seed_fn so
        # multi-dispatch windows can reseed per dispatch
        sx, sy, seed_fn = pixel_grid
        rng0 = seed_fn(ctx.seed_bits)

    Hp, Wp, CC = ctx.material_tf.shape
    TH, TW = Hp - 1, Wp - 1
    xy_packed = vol_kind == "xy"
    if xy_packed:
        VD, VHp, VWp = vol_dims
        VH, VW = VHp - 1, VWp - 1
    else:
        VDp, VHp, VWp = vol_dims
        VD, VH, VW = VDp - 1, VHp - 1, VWp - 1

    ld = ctx.light_direction
    lnorm = jnp.sqrt(jnp.sum(ld * ld))
    ldn = ld / jnp.maximum(lnorm, 1e-30)

    want_tf = "material_tf" in wrt or "light_spectrum" in wrt
    want_vol = "density" in wrt
    n_vol_rows = int(np.prod(vol_dims))
    vwidth = 4 if xy_packed else 8

    # ---- pass 1: forward, taping everything the reverse scatters need ----
    def fwd_body(carry, _):
        p, rng = carry
        p2, rng2, _, it = M._render_body(
            p, rng, None, sx, sy, ctx, n_bins, volume_filter,
            diff=False, collect=True, sample_volume_fn=sample_volume_fn,
        )
        ex = it["tf_extras"]
        rows, fx, fy = ex["rows"], ex["fx"], ex["fy"]
        tape = dict(
            emitted=it["emitted"], respawn=it["respawn"], pre_bin=it["pre_bin"],
            alpha=it["alpha"], albedo=it["albedo"], g=it["g"],
            hg_cos=it["hg_cos"],
            null=it["null"], scatter=it["scatter"],
            fx=fx,
        )
        if "extinction" in wrt:
            tape["dist"] = it["dist"]
        if want_tf:
            tape["tf_row"] = ex["row_idx"]
            tape["fy"] = fy
            if env_mode:
                # escape radiance comes from the env map; the light spectrum
                # is never sampled, so its (pathwise) gradient is zero
                tape["light_w"] = jnp.zeros_like(fx)
            else:
                ddot = (it["pre_dir"][0] * ldn[0] + it["pre_dir"][1] * ldn[1]
                        + it["pre_dir"][2] * ldn[2])
                dI = jnp.where(lnorm < EPS, 1.0,
                               jnp.where(it["emitted"] > 0.0, ddot, 0.0))
                tape["light_w"] = jnp.where(it["oob"], dI * 5.0, 0.0)
        if want_env:
            # equirect addressing of the escape lookup (_sample_environment):
            # pathwise d(emitted)/d(env texel) = 2.7 * bilinear corner weight
            # on the wavelength band's channel, for escaping lanes
            dxd, dyd, dzd = it["pre_dir"]
            HpE, WpE, _ = ctx.environment.shape
            inv_pi = jnp.float32(1.0 / np.pi)
            uE = jnp.arctan2(dxd, -dzd) * inv_pi * 0.5 + 0.5
            vE = jnp.arcsin(-dyd) * 2.0 * inv_pi * 0.5 + 0.5
            ebx, efx = _packed_base_frac(uE, WpE - 1)
            eby, efy = _packed_base_frac(vE, HpE - 1)
            tape["env_row"] = eby * WpE + ebx
            tape["env_fx"], tape["env_fy"] = efx, efy
            lam = it["pre_wavelength"]
            tape["env_band"] = jnp.where(
                lam < 500.0, 2, jnp.where(lam < 600.0, 1, 0)
            ).astype(jnp.int32)
            tape["env_w"] = jnp.where(it["oob"], jnp.float32(2.7), 0.0)
        if want_vol:
            # per-channel TF slope d(value)/d(density coord) from the same
            # row: (y-lerped row1 - row0) * table height; zero in the clamp
            # zone because the pad duplicates the edge row
            c00 = rows[..., 0:3]
            c01 = rows[..., 4:7]
            c10 = rows[..., 8:11]
            c11 = rows[..., 12:15]
            fxc = fx[..., None]
            tape["slopes"] = (
                (c10 + (c11 - c10) * fxc) - (c00 + (c01 - c00) * fxc)
            ) * TH
            u, v, w = it["sample_pos"]
            vbx, vfx = _packed_base_frac(u, VW)
            vby, vfy = _packed_base_frac(v, VH)
            if xy_packed:
                s = w * VD - 0.5
                i0 = jnp.floor(s)
                vfz = s - i0
                z0 = jnp.clip(i0.astype(jnp.int32), 0, VD - 1)
                z1 = jnp.clip(i0.astype(jnp.int32) + 1, 0, VD - 1)
                plane = vby * VWp + vbx
                tape["vol_row0"] = z0 * (VHp * VWp) + plane
                tape["vol_row1"] = z1 * (VHp * VWp) + plane
            else:
                vbz, vfz = _packed_base_frac(w, VD)
                tape["vol_row0"] = (vbz * VHp + vby) * VWp + vbx
            if volume_filter == "quasicubic":
                # corner-value cotangents use the WARPED weights (the
                # forward's smoothstep warp; positions are detached so no
                # 6f(1-f) position-chain term arises) — see
                # _trilinear_corners
                warp = lambda f: f * f * (3.0 - 2.0 * f)
                vfx, vfy, vfz = warp(vfx), warp(vfy), warp(vfz)
            tape["vfx"], tape["vfy"], tape["vfz"] = vfx, vfy, vfz
        return (p2, rng2), tape

    if tape_in is None:
        (state_out, _), tape = jax.lax.scan(fwd_body, (state0, rng0), None,
                                            length=steps)
    else:
        state_out, tape = state_out_in, tape_in
    if forward_only:
        return state_out, tape

    # ---- image cotangent -> per-deposit cotangent (as the raw path) ------
    cm = jnp.matmul(jnp.asarray(XYZ_TO_SRGB_KERNEL), ctx.bin_xyz,
                    precision=jax.lax.Precision.HIGHEST)  # (3, B)
    g_rad = jnp.einsum("hwc,cb->bhw", g_image, cm,
                       precision=jax.lax.Precision.HIGHEST)
    if streams > 1:
        # broadcast from g_rad's own pixel dims, not (resolution,
        # resolution): inside shard_map the rows axis is the LOCAL shard
        g_rad = jnp.broadcast_to(
            g_rad[:, None] / streams, (n_bins, streams) + g_rad.shape[1:]
        )
    if m_final is None:
        m_final = jnp.maximum(state_out.samples, 1).astype(jnp.float32)
    g_rad_scaled = g_rad / m_final[None]

    def deposit_cotangent(pre_bin):
        # B is tiny (12): a B-way masked sum of elementwise selects instead
        # of a per-lane gather (take_along_axis lowers to a 1M-index
        # gather per step)
        sel = jnp.zeros(pre_bin.shape, jnp.float32)
        for b in range(n_bins):
            sel = sel + jnp.where(pre_bin == b, g_rad_scaled[b], 0.0)
        return sel

    # ---- reverse scan: cotangent propagation + per-step row scatters -----
    # Scatters stay inside the scan, one per table per step. The levers on
    # their cost are the number of indices emitted — one packed corner row
    # per table per lane-step, the ``wrt`` gating, and ``scatter_stride``.
    def scatter_step(adj, t, c, cb, weight=1.0):
        """Analytic per-step table scatters for one tape row, given the
        step's (eventual contribution, deposit cotangent)."""
        q = cb * c * weight
        alpha, albedo, g = t["alpha"], t["albedo"], t["g"]
        null, scat = t["null"], t["scatter"]
        grad_alpha = (
            jnp.where(null, -q / jnp.maximum(1.0 - alpha, 1e-12), 0.0)
            + jnp.where(scat, q / jnp.maximum(alpha, 1e-12), 0.0)
        )
        grad_albedo = jnp.where(scat, q / jnp.maximum(albedo, 1e-12), 0.0)
        aniso = jnp.abs(g) >= EPS
        cosd = t["hg_cos"]
        g2 = g * g
        hg_score = (-2.0 * g / jnp.maximum(1.0 - g2, 1e-9)
                    - 3.0 * (g - cosd)
                    / jnp.maximum(1.0 + g2 - 2.0 * g * cosd, 1e-9))
        grad_graw = jnp.where(scat & aniso, q * hg_score, 0.0) * 2.0

        out = dict(adj)
        fx = t["fx"]
        if want_tf:
            # one 18-wide row: 4 corners x (albedo, alpha, g_raw, 0) + light
            fy = t["fy"]
            w00 = (1 - fx) * (1 - fy)
            w01 = fx * (1 - fy)
            w10 = (1 - fx) * fy
            w11 = fx * fy
            gl = cb * weight * t["light_w"]
            zero = jnp.zeros_like(fx)
            v18 = jnp.stack(
                [grad_albedo * w00, grad_alpha * w00, grad_graw * w00, zero,
                 grad_albedo * w01, grad_alpha * w01, grad_graw * w01, zero,
                 grad_albedo * w10, grad_alpha * w10, grad_graw * w10, zero,
                 grad_albedo * w11, grad_alpha * w11, grad_graw * w11, zero,
                 gl * (1 - fx), gl * fx],
                axis=-1,
            )
            out["g_tf"] = adj["g_tf"].at[t["tf_row"].reshape(-1)].add(
                v18.reshape(-1, CC))
        if want_env:
            # one 12-wide row: 4 corners x 3 channels, the wavelength band's
            # channel selected per lane (one-hot elementwise masks)
            efx, efy = t["env_fx"], t["env_fy"]
            ew00 = (1 - efx) * (1 - efy)
            ew01 = efx * (1 - efy)
            ew10 = (1 - efx) * efy
            ew11 = efx * efy
            gE = cb * weight * t["env_w"]
            band = t["env_band"]
            chm = [(band == c).astype(jnp.float32) for c in range(3)]
            cols = [gE * wc * chm[c]
                    for wc in (ew00, ew01, ew10, ew11) for c in range(3)]
            v12 = jnp.stack(cols, axis=-1)
            out["g_env"] = adj["g_env"].at[t["env_row"].reshape(-1)].add(
                v12.reshape(-1, 12))
        if want_vol:
            # density chain through the TF, trilinear corner-row scatter
            # (vol_scatter_fn overrides the lowering — the slab wrapper
            # routes it: all_gather indices+updates -> owner-side add)
            vol_scatter = vol_scatter_fn or (
                lambda a, i, u: a.at[i].add(u))
            grad_dens = (grad_albedo * t["slopes"][..., 0]
                         + grad_alpha * t["slopes"][..., 1]
                         + grad_graw * t["slopes"][..., 2])
            vfx, vfy, vfz = t["vfx"], t["vfy"], t["vfz"]
            w4 = jnp.stack([(1 - vfy) * (1 - vfx), (1 - vfy) * vfx,
                            vfy * (1 - vfx), vfy * vfx], axis=-1)
            if xy_packed:
                g_vol = vol_scatter(
                    adj["g_vol"], t["vol_row0"].reshape(-1),
                    ((grad_dens * (1 - vfz))[..., None] * w4).reshape(-1, 4))
                out["g_vol"] = vol_scatter(
                    g_vol, t["vol_row1"].reshape(-1),
                    ((grad_dens * vfz)[..., None] * w4).reshape(-1, 4))
            else:
                v8 = jnp.concatenate(
                    [(grad_dens * (1 - vfz))[..., None] * w4,
                     (grad_dens * vfz)[..., None] * w4], axis=-1)
                out["g_vol"] = vol_scatter(
                    adj["g_vol"], t["vol_row0"].reshape(-1), v8.reshape(-1, 8))
        return out

    def cotangent_update(carry, t):
        """(c, cb) propagation + the (always exact) extinction score term."""
        dep = t["respawn"]
        c = jnp.where(dep, t["emitted"], carry["c"])
        cb = jnp.where(dep, deposit_cotangent(t["pre_bin"]), carry["cb"])
        out = dict(carry, c=c, cb=cb)
        if "extinction" in wrt:
            out["g_ext"] = carry["g_ext"] + jnp.sum(
                c * cb * (1.0 / ctx.extinction - t["dist"]))
        return out

    if adj_in is None:
        adj_in = _packed_adj_init(ctx, wrt)
    zero = jnp.zeros_like(tape["emitted"][0])
    if cot_in is None:
        carry0 = dict(c=zero, cb=zero)
    else:
        carry0 = dict(c=cot_in["c"], cb=cot_in["cb"])
    if "extinction" in wrt:
        carry0["g_ext"] = adj_in["g_ext"]
    adj0 = {}
    if want_tf:
        adj0["g_tf"] = adj_in["g_tf"]
    if want_vol:
        adj0["g_vol"] = adj_in["g_vol"]
    if want_env:
        adj0["g_env"] = adj_in["g_env"]

    if scatter_stride == 1:
        def rev_body(carry, t):
            cot = cotangent_update(
                {k: v for k, v in carry.items() if k not in adj0}, t)
            adj = scatter_step({k: carry[k] for k in adj0}, t,
                               cot["c"], cot["cb"])
            return dict(cot, **adj), None

        acc, _ = jax.lax.scan(rev_body, dict(carry0, **adj0), tape,
                              reverse=True)
    else:
        # Stochastic gradient thinning: pass A propagates cotangents exactly
        # (and the extinction term); pass B scatters only every stride-th
        # step, weighted by stride.
        assert steps % scatter_stride == 0, \
            "scatter_stride must divide steps (unbiasedness)"

        def cot_body(carry, t):
            out = cotangent_update(carry, t)
            return out, (out["c"], out["cb"])

        acc, (c_all, cb_all) = jax.lax.scan(cot_body, carry0, tape,
                                            reverse=True)
        count = steps // scatter_stride
        if scatter_mode == "importance":
            bits = (ctx.seed_bits if pick_bits is None
                    else jnp.uint32(pick_bits)) ^ jnp.uint32(0x7F4A7C15)
            if pixel_grid is None:
                pick_state = sampling.seed_state(ix, seed_iy, bits)
            else:
                # slab wrapper: seed_fn carries this device's GLOBAL
                # pixel/stream coords, so picks stay mesh-shape invariant
                pick_state = seed_fn(bits)
            adj0 = _importance_scatter(
                adj0, {k: tape[k] for k in tape
                       if k not in ("emitted", "respawn", "pre_bin", "dist")},
                c_all, cb_all, count, pick_state,
                scatter_step, steps,
                want_vol=want_vol, want_tf=want_tf, want_env=want_env)
        else:
            if scatter_phase is None:
                phase = (ctx.seed_bits % jnp.uint32(scatter_stride)).astype(jnp.int32)
            else:
                # explicit phase (tests / callers managing their own
                # rotation): averaging the k phase gradients at a FIXED seed
                # reproduces the exact gradient identically (the phases
                # partition the steps)
                phase = jnp.asarray(scatter_phase, jnp.int32)
            sel = phase + scatter_stride * jnp.arange(count, dtype=jnp.int32)
            take = lambda x: jnp.take(x, sel, axis=0)
            sub = (jax.tree.map(take, tape), take(c_all), take(cb_all))

            def scat_body(adj, inp):
                t, c, cb = inp
                return scatter_step(adj, t, c, cb,
                                    weight=jnp.float32(scatter_stride)), None

            adj0, _ = jax.lax.scan(scat_body, adj0, sub)
        acc = dict(acc, **adj0)

    cot_out = dict(c=acc["c"], cb=acc["cb"]) if return_cot else None
    acc = {k: acc[k] for k in ("g_ext", "g_tf", "g_vol", "g_env") if k in acc}
    image = M.radiance_to_rgb(state_out.radiance, ctx.bin_xyz)
    if raw_adjoints:
        return ((state_out, image, acc, cot_out) if return_cot
                else (state_out, image, acc))
    # ---- contract packed adjoints -> raw tables (dense pack transposes) --
    grads = _contract_packed_adjoints(acc, ctx, wrt)
    return ((state_out, image, grads, cot_out) if return_cot
            else (state_out, image, grads))


@functools.partial(
    jax.jit,
    static_argnames=("steps", "n_bins", "volume_filter", "wrt",
                     "scatter_stride", "scatter_mode"))
def prb_render_and_grads(state0, ctx, g_image, steps: int, n_bins: int,
                         volume_filter: str = "linear",
                         wrt: frozenset = ALL_WRT,
                         scatter_stride: int = 1,
                         scatter_mode: str = "stride",
                         scatter_phase=None,
                         pick_bits=None):
    """Jitted forward dispatch + hand-derived backward:
    (state_out, image, grads). Forward results are bit-identical to
    M.render on the same inputs. Dispatches on the ctx's table
    representation: fused/packed tables use the fast packed-adjoint
    backward, raw tables the reference replay path; grads always address
    the raw tables. ``wrt`` restricts which gradients are computed and
    ``scatter_stride`` enables stochastic gradient thinning (packed path
    only; see spectral_backward_packed)."""
    wrt = frozenset(wrt)
    packed_vol = (isinstance(ctx.density, interp.PackedVolume)
                  or ctx.density.ndim == 4)
    if ctx.material_tf.shape[-1] == 18 and packed_vol:
        return spectral_backward_packed(state0, ctx, g_image, steps, n_bins,
                                        volume_filter, wrt=wrt,
                                        scatter_stride=scatter_stride,
                                        scatter_mode=scatter_mode,
                                        pick_bits=pick_bits,
                                        scatter_phase=scatter_phase)
    if ctx.material_tf.shape[-1] == 4 and not packed_vol and ctx.density.ndim == 3:
        return spectral_backward(state0, ctx, g_image, steps, n_bins,
                                 volume_filter)
    raise ValueError(
        "prb_render_and_grads needs either a fully raw ctx (pack_tables=False) "
        "or the standard packed ctx (fused 18-wide TF + packed volume); got "
        f"material_tf {ctx.material_tf.shape}, density "
        f"{ctx.density.shape4 if isinstance(ctx.density, interp.PackedVolume) else ctx.density.shape}"
    )


# ==========================================================================
# Multi-dispatch (scan-batched) packed PRB — the production fwd+bwd shape
# ==========================================================================

def _dispatch_phase(k, seed, n_dispatches, scatter_stride):
    """Thinning phase for window dispatch k. Deterministic k % stride when
    the window covers every phase uniformly (K % stride == 0); otherwise
    the per-dispatch frame seed picks the phase — random but unbiased in
    expectation over seeds, so short windows (e.g. an optimizer with
    dispatches_per_step < stride) never systematically skip step phases
    (k % stride with ks resetting every window would scatter only phases
    0..K-1 forever)."""
    stride = jnp.uint32(max(scatter_stride, 1))
    if scatter_stride <= 1 or n_dispatches % scatter_stride == 0:
        return (k % stride).astype(jnp.int32)
    return (seed % stride).astype(jnp.int32)


def _prb_many_core(state0, ctx, seeds, g_image, steps, n_bins, volume_filter,
                   wrt, scatter_stride, m_final, starts=None,
                   hooks=None, raw_adjoints=False,
                   scatter_mode: str = "stride"):
    """Scan the packed-adjoint backward over K per-dispatch seeds inside one
    device program (the fwd+bwd analog of models/mcm_spectral.render_many):
    packed adjoints accumulate across dispatches and contract to the raw
    tables ONCE at the end. The scatter-thinning phase rotates
    deterministically with the dispatch index, so any window with
    K % scatter_stride == 0 covers every step phase uniformly.

    ``starts=None`` (sequential mode): forward dispatch order, each
    dispatch's cotangent carry starting from zero — bit-equivalent to K
    sequential single-dispatch calls; score chains truncate at dispatch
    boundaries. ``starts`` given (window mode; the stacked per-dispatch
    START states from the phase-0 forward): REVERSE dispatch order with the
    {c, cb} deposit-cotangent carry threaded across boundaries — the
    window-exact estimator (per-seed equal to autodiff of the K-dispatch
    surrogate when combined with window-final ``m_final``).

    ``hooks``: optional dict of the slab-sharded overrides forwarded to
    spectral_backward_packed (sample_volume_fn, vol_scatter_fn, vol_meta,
    pixel_grid) plus vol_adj_rows for the adjoint sizing;
    ``raw_adjoints``: return the uncontracted packed adjoints (the slab
    wrapper runs its own distributed contraction)."""
    hooks = dict(hooks or {})
    vol_adj_rows = hooks.pop("vol_adj_rows", None)
    ks = jnp.arange(seeds.shape[0], dtype=jnp.uint32)
    adj0 = _packed_adj_init(ctx, wrt, vol_meta=hooks.get("vol_meta"),
                            vol_adj_rows=vol_adj_rows)

    if starts is None:
        def body(carry, inp):
            state, adj = carry
            seed, k = inp
            c = ctx._replace(seed_bits=seed)
            phase = _dispatch_phase(k, seed, seeds.shape[0],
                                    scatter_stride)
            state, _, adj = spectral_backward_packed(
                state, c, g_image, steps, n_bins, volume_filter, wrt=wrt,
                scatter_stride=scatter_stride, scatter_mode=scatter_mode,
                scatter_phase=phase,
                m_final=m_final, adj_in=adj, raw_adjoints=True, **hooks)
            return (state, adj), None

        (state, acc), _ = jax.lax.scan(body, (state0, adj0), (seeds, ks))
        image = M.radiance_to_rgb(state.radiance, ctx.bin_xyz)
        if raw_adjoints:
            return state, image, acc
        return state, image, _contract_packed_adjoints(acc, ctx, wrt)

    zero = jnp.zeros_like(state0.px)
    cot0 = dict(c=zero, cb=zero)

    def body(carry, inp):
        cot, adj = carry
        st_k, seed, k = inp
        c = ctx._replace(seed_bits=seed)
        phase = _dispatch_phase(k, seed, seeds.shape[0], scatter_stride)
        _, _, adj, cot = spectral_backward_packed(
            st_k, c, g_image, steps, n_bins, volume_filter, wrt=wrt,
            scatter_stride=scatter_stride, scatter_mode=scatter_mode,
            scatter_phase=phase,
            m_final=m_final, adj_in=adj, raw_adjoints=True,
            cot_in=cot, return_cot=True, **hooks)
        return (cot, adj), None

    (_, acc), _ = jax.lax.scan(body, (cot0, adj0), (starts, seeds, ks),
                               reverse=True)
    if raw_adjoints:
        return acc
    return _contract_packed_adjoints(acc, ctx, wrt)


def _tape_forward_sweep(state0, ctx, seeds, steps, n_bins, volume_filter,
                        wrt):
    """One taped forward scan over the K dispatches, stacking per-dispatch
    tapes (K x steps x lanes fields in device memory). Returns
    (state_f, tapes, image, m_final)."""
    def body_f(state, seed):
        state2, tape = spectral_backward_packed(
            state, ctx._replace(seed_bits=seed), None, steps, n_bins,
            volume_filter, wrt=wrt, forward_only=True)
        return state2, tape

    state_f, tapes = jax.lax.scan(body_f, state0, seeds)
    image = M.radiance_to_rgb(state_f.radiance, ctx.bin_xyz)
    m_final = jnp.maximum(state_f.samples, 1).astype(jnp.float32)
    return state_f, tapes, image, m_final


def _tape_reverse_sweep(state0, ctx, seeds, tapes, state_f, m_final, g_image,
                        steps, n_bins, volume_filter, wrt, scatter_stride,
                        scatter_mode: str = "stride"):
    """Reverse dispatch scan over stored tapes with the cotangent carry
    threaded across boundaries; contracts the packed adjoints once."""
    ks = jnp.arange(seeds.shape[0], dtype=jnp.uint32)
    zero = jnp.zeros_like(state0.px)
    cot0 = dict(c=zero, cb=zero)
    adj0 = _packed_adj_init(ctx, wrt)

    def body_b(carry, inp):
        cot, adj = carry
        tape_k, seed, k = inp
        c = ctx._replace(seed_bits=seed)
        phase = _dispatch_phase(k, seed, seeds.shape[0], scatter_stride)
        _, _, adj, cot = spectral_backward_packed(
            state0, c, g_image, steps, n_bins, volume_filter, wrt=wrt,
            scatter_stride=scatter_stride, scatter_mode=scatter_mode,
            scatter_phase=phase,
            m_final=m_final, adj_in=adj, raw_adjoints=True,
            cot_in=cot, return_cot=True,
            tape_in=tape_k, state_out_in=state_f)
        return (cot, adj), None

    (_, acc), _ = jax.lax.scan(body_b, (cot0, adj0), (tapes, seeds, ks),
                               reverse=True)
    return _contract_packed_adjoints(acc, ctx, wrt)


def _prb_many_tape(state0, ctx, seeds, g_image, steps, n_bins, volume_filter,
                   wrt, scatter_stride, scatter_mode: str = "stride"):
    """Window backward with TAPE storage: one taped forward sweep + one
    reverse sweep over stored tapes — one simulate total instead of the
    forward-storage mode's two (phase-0 + taped re-simulate). Returns
    (state_f, image, grads); window-final m_final and cotangent threading
    as in _prb_many_core(starts=...)."""
    state_f, tapes, image, m_final = _tape_forward_sweep(
        state0, ctx, seeds, steps, n_bins, volume_filter, wrt)
    grads = _tape_reverse_sweep(state0, ctx, seeds, tapes, state_f, m_final,
                                g_image, steps, n_bins, volume_filter, wrt,
                                scatter_stride, scatter_mode)
    return state_f, image, grads


# window_storage="auto" keeps the stacked tape while it takes at most this
# share of the device's memory limit, and re-simulates ("forward") above
# it. The tape shares the device with the packed tables (a 512^3 u8
# corner table is 1.08 GB), the packed f32 adjoint (0.54 GB at 256^3), the
# lane state and XLA's temporaries of the reverse scan, so it gets a
# quarter and they keep the rest.
_TAPE_MEMORY_SHARE = 0.25
# the limit where the backend reports no memory limit (the CPU)
_TAPE_LIMIT_UNREPORTED_BYTES = 6 * 1024**3


def _tape_auto_limit_bytes(device=None) -> int:
    """Largest stacked tape window_storage="auto" keeps on ``device``
    (default: the first local device)."""
    stats = (device or jax.local_devices()[0]).memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return _TAPE_LIMIT_UNREPORTED_BYTES
    return int(limit * _TAPE_MEMORY_SHARE)


def _window_tape_bytes(state0, steps, n_dispatches, wrt):
    """Static estimate of the stacked-tape device-memory footprint."""
    lanes = int(np.prod(state0.px.shape))
    n_fields = 12  # base: emitted/respawn/pre_bin/alpha/albedo/g/hg_cos/...
    if "density" in wrt:
        n_fields += 7  # slopes(3) + vf(3) + vol_row0 (+row1 xy: ~same)
    if "material_tf" in wrt or "light_spectrum" in wrt:
        n_fields += 3
    return lanes * steps * n_dispatches * n_fields * 4


def _window_forward(state0, ctx, seeds, steps, n_bins, volume_filter,
                    with_states: bool, hooks=None):
    """Untaped K-dispatch forward: (m_final, image, start_states, state_f).
    ``m_final`` is the incremental-mean normalizer (max(samples, 1) at
    window end); ``start_states`` stacks each dispatch's START state over K
    (None unless ``with_states`` — the window backward's reverse-order
    inputs). ``hooks``: slab overrides (pixel_grid gives this device's
    (sx, sy, rng-seeding) closure inputs; sample_volume_fn the routed
    gather)."""
    hooks = hooks or {}
    sample_volume_fn = hooks.get("sample_volume_fn")
    if not with_states and not hooks:
        state_f, image = M.render_many(state0, ctx, seeds, steps=steps,
                                       n_bins=n_bins,
                                       volume_filter=volume_filter)
        starts = None
    else:
        resolution = state0.px.shape[-1]
        streams = state0.px.shape[0] if state0.px.ndim == 3 else 1
        if hooks.get("pixel_grid") is not None:
            # slab mode: (sx, sy, seed_fn) — per-dispatch reseeding needs
            # the seeding COORDS, so the hook supplies a seed function
            sx, sy, seed_fn = hooks["pixel_grid"]
        else:
            ix, iy, seed_iy = M._pixel_grid(resolution, streams)
            sx, sy = geometry.screen_position(ix, iy, 1.0 / resolution)
            seed_fn = lambda bits: sampling.seed_state(ix, seed_iy, bits)

        def dispatch(p, seed_bits):
            rng = seed_fn(seed_bits)

            def body(_, carry):
                q, r = carry
                q, r, _ = M._render_body(q, r, None, sx, sy, ctx, n_bins,
                                         volume_filter, diff=False,
                                         sample_volume_fn=sample_volume_fn)
                return (q, r)

            p2, _ = jax.lax.fori_loop(0, steps, body, (p, rng))
            return p2, p

        state_f, starts = jax.lax.scan(dispatch, state0, seeds)
        if not with_states:
            starts = None
        image = M.radiance_to_rgb(state_f.radiance, ctx.bin_xyz)
    m = jnp.maximum(state_f.samples, 1).astype(jnp.float32)
    return m, image, starts, state_f


@functools.partial(
    jax.jit,
    static_argnames=("steps", "n_bins", "volume_filter", "wrt",
                     "scatter_stride", "scatter_mode", "window",
                     "window_storage"))
def prb_render_and_grads_many(state0, ctx, seeds, g_image, steps: int,
                              n_bins: int, volume_filter: str = "linear",
                              wrt: frozenset = ALL_WRT,
                              scatter_stride: int = 1,
                              scatter_mode: str = "stride",
                              window: bool = True,
                              window_storage: str = "auto"):
    """K taped fwd+bwd dispatches in one device program:
    (state_out, image, grads) with grads summed over the window and
    addressing the raw tables. ``seeds``: (K,) uint32 per-dispatch frame
    seeds (per-dispatch ctx.seed_bits is ignored, like render_many).

    ``window=True`` (default): the window-exact estimator. A phase-0
    untaped forward over the K dispatches collects each dispatch's start
    state and the window-final sample counts; the backward then runs in
    REVERSE dispatch order threading the deposit-cotangent carry across
    dispatch boundaries, so a path spanning dispatches keeps its full
    score chain. Per-seed equal to autodiff of the K-dispatch surrogate
    window (render_sequence_diff) — pinned by
    tests/test_prb_packed.py::test_window_matches_autodiff_multi_dispatch.
    ``window=False``: bit-equivalent to K sequential single-dispatch
    ``prb_render_and_grads`` calls with summed grads — each dispatch's
    score chain truncates at its own boundary and deposits normalize by
    per-dispatch counts. This is what an optimizer stepping once per
    dispatch computes; kept for composition tests and benchmarking the
    no-phase-0 shape.

    ``window_storage``: "tape" stores all K dispatch tapes from ONE taped
    forward sweep (fastest — saves a full re-simulate; K x steps x lanes
    fields in device memory); "forward" stores only per-dispatch start
    states and re-simulates
    each dispatch taped during the reverse scan (low memory); "auto"
    picks "tape" while the stacked tape stays under a quarter of the
    device's memory (_tape_auto_limit_bytes).
    """
    wrt = frozenset(wrt)
    if not window:
        return _prb_many_core(state0, ctx, seeds, g_image, steps, n_bins,
                              volume_filter, wrt, scatter_stride, None,
                              scatter_mode=scatter_mode)
    if window_storage == "auto":
        window_storage = (
            "tape" if _window_tape_bytes(state0, steps, seeds.shape[0], wrt)
            <= _tape_auto_limit_bytes() else "forward")
    if window_storage == "tape":
        return _prb_many_tape(state0, ctx, seeds, g_image, steps, n_bins,
                              volume_filter, wrt, scatter_stride,
                              scatter_mode)
    m_final, image, starts, state_f = _window_forward(
        state0, ctx, seeds, steps, n_bins, volume_filter, with_states=True)
    grads = _prb_many_core(state0, ctx, seeds, g_image, steps, n_bins,
                           volume_filter, wrt, scatter_stride, m_final,
                           starts=starts, scatter_mode=scatter_mode)
    return state_f, image, grads


@functools.partial(
    jax.jit,
    static_argnames=("steps", "n_bins", "volume_filter", "wrt",
                     "scatter_stride", "scatter_mode", "window_storage"))
def prb_loss_and_grads(state0, ctx, seeds, target, steps: int, n_bins: int,
                       volume_filter: str = "linear",
                       wrt: frozenset = frozenset({"density"}),
                       scatter_stride: int = 1,
                       scatter_mode: str = "stride",
                       window_storage: str = "auto"):
    """MSE loss + hand-derived gradients over a K-dispatch render window —
    the packed-PRB analog of ``jax.value_and_grad(spectral_render_loss)``
    (optim.py), and the engine behind optim.fit_spectral(method="prb").

    Phase 0 (untaped forward scan) produces the window-final image — the
    loss and its cotangent g = 2 (img - target) / numel — plus the
    incremental-mean normalizer and each dispatch's start state; phase 1
    replays the dispatches in REVERSE with tapes, threading the
    deposit-cotangent carry across dispatch boundaries, and accumulates
    the packed adjoints. Returns (state_out, image, loss, grads).
    Gradients address the RAW tables; at scatter_stride=1 they equal
    autodiff of the REINFORCE-surrogate window PER SEED
    (tests/test_prb_packed.py::test_window_matches_autodiff_multi_dispatch).
    """
    wrt = frozenset(wrt)
    if window_storage == "auto":
        window_storage = (
            "tape" if _window_tape_bytes(state0, steps, seeds.shape[0], wrt)
            <= _tape_auto_limit_bytes() else "forward")
    if window_storage == "tape":
        state_f, tapes, image, m_final = _tape_forward_sweep(
            state0, ctx, seeds, steps, n_bins, volume_filter, wrt)
        g_image = 2.0 * (image - target) / jnp.float32(image.size)
        grads = _tape_reverse_sweep(
            state0, ctx, seeds, tapes, state_f, m_final, g_image, steps,
            n_bins, volume_filter, wrt, scatter_stride, scatter_mode)
    else:
        m_final, image, starts, state_f = _window_forward(
            state0, ctx, seeds, steps, n_bins, volume_filter,
            with_states=True)
        g_image = 2.0 * (image - target) / jnp.float32(image.size)
        grads = _prb_many_core(state0, ctx, seeds, g_image, steps, n_bins,
                               volume_filter, wrt, scatter_stride, m_final,
                               starts=starts, scatter_mode=scatter_mode)
    loss = jnp.mean((image - target) ** 2)
    return state_f, image, loss, grads
