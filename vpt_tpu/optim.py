"""Differentiable inverse rendering: recover a density grid (and transfer
function) from target renders by gradient descent.

The reference is forward-only; this is the build's new capability
(BASELINE.json config 4). The EAM forward model (models/raymarch.eam_frame)
is smooth in (density, tf_table), so plain autodiff through the compositing
scan gives exact gradients; the spectral MCM path gets its gradients from
the score-function surrogate in models/mcm_spectral_grad.

Sharding: images/losses are sharded over the "rays" mesh axis, parameters
replicated — XLA inserts the gradient all-reduce (NCCL psum over NVLink)
automatically when differentiating replicated params against a sharded loss.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from vpt_tpu.models.raymarch import _seed_to_offset, eam_frame


class InverseState(NamedTuple):
    params: dict  # {"density": (D,H,W), "tf_table": (256,256,4)} (any subset)
    opt_state: optax.OptState
    step: jax.Array


def save_inverse_checkpoint(path: str, istate: InverseState) -> None:
    """Persist an optimization state (params + opt_state + step) — the
    inverse-rendering analog of session.save_checkpoint (SURVEY §5:
    (params, opt_state) checkpointing for BASELINE config 4). Stored as
    flattened pytree leaves; restore against a structurally identical
    template (a fresh init from the same optimizer/params)."""
    import numpy as np

    leaves = jax.tree.leaves(istate)
    np.savez(path, n_leaves=len(leaves),
             **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)})


def load_inverse_checkpoint(path: str, template: InverseState) -> InverseState:
    """Restore an InverseState saved by save_inverse_checkpoint.

    ``template``: a fresh InverseState with the same params/optimizer
    structure (its leaf VALUES are ignored). Resuming is exact: the step
    function is deterministic given (state, seeds), so an interrupted and
    a straight-through run produce bit-identical trajectories."""
    import numpy as np

    leaves, treedef = jax.tree.flatten(template)
    with np.load(path) as data:
        n = int(data["n_leaves"])
        if n != len(leaves):
            raise ValueError(
                f"checkpoint has {n} leaves; template has {len(leaves)} "
                "(different params subset or optimizer?)")
        new = [jnp.asarray(data[f"leaf_{i}"]) for i in range(n)]
    return jax.tree.unflatten(treedef, new)


def sanitize_grads(grads, clip: float):
    """Make Monte-Carlo gradients safe for Adam: replace NaN with 0,
    +/-inf with +/-clip, and clamp every element to [-clip, clip].

    Score-function estimators have heavy-tailed per-event terms — the event
    scores divide by event probabilities floored at 1e-12
    (kernels/spectral_backward.py:210-213), so a lane that samples an
    event whose probability is denormal contributes a ~1e12-scale term, and
    the scatter-add accumulation at clamp corners (the reference's
    clamped-sample-before-OOB quirk funnels every out-of-bounds lane onto
    border voxels) can overflow float32 to inf. Adam converts a single inf
    gradient element into a NaN parameter (inf/sqrt(inf^2)), permanently
    corrupting that voxel. Clipping at ``clip`` (default 1e3 — ~6 orders
    above typical density-grad magnitudes, a pure spike guard) bounds the
    update direction without touching well-behaved elements."""
    return jax.tree.map(
        lambda g: jnp.clip(
            jnp.nan_to_num(g, nan=0.0, posinf=clip, neginf=-clip),
            -clip, clip),
        grads)


def eam_loss(params, inv_mvp, offset, target, static):
    """MSE between the EAM forward render and a target image."""
    img = eam_frame(
        inv_mvp,
        params["density"],
        params.get("tf_table", static["tf_table"]),
        static["extinction"],
        offset,
        slices=static["slices"],
        resolution=static["resolution"],
        volume_filter=static["volume_filter"],
    )
    return jnp.mean((img - target) ** 2)


def make_inverse_step(optimizer, static, learn_tf: bool = False):
    """Build a jitted training step closed over the optimizer and statics."""

    @jax.jit
    def step(state: InverseState, inv_mvp, offset, target):
        loss, grads = jax.value_and_grad(eam_loss)(
            state.params, inv_mvp, offset, target, static
        )
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        # densities are physical: clamp to [0, 1]
        params = dict(params, density=jnp.clip(params["density"], 0.0, 1.0))
        if "tf_table" in params:
            params = dict(params, tf_table=jnp.clip(params["tf_table"], 0.0, 1.0))
        return InverseState(params, opt_state, state.step + 1), loss

    return step


def spectral_render_loss(params, state0, base_ctx, seeds, target, steps, n_bins,
                         pack_params: bool = True):
    """MSE between a differentiable spectral MCM render and a target.

    ``params`` may override any of: density, material_tf, light_spectrum,
    extinction (raw/unpacked tables). Gradients through the discrete
    Woodcock events use the REINFORCE surrogate
    (models/mcm_spectral._surrogate).

    ``pack_params``: corner-pack the raw table params *inside* the
    differentiated function (ops/interp.pack_*_jnp). Bit-identical forward
    and mathematically identical gradients, but ~8x fewer gather/scatter ops
    on the hot path (one packed row per sample instead of 8 corners). The
    non-packed path is kept for validation. Requires base_ctx tables that
    are packed too (renderer pack_tables=True) for any non-learned tables.
    """
    from vpt_tpu.models.mcm_spectral import render_sequence_diff
    from vpt_tpu.ops import interp

    if pack_params:
        packers = {
            "density": interp.pack_volume_corners_jnp,
            "material_tf": interp.pack_tex2d_corners_jnp,
            "light_spectrum": interp.pack_tex1d_corners_jnp,
            "environment": interp.pack_tex2d_corners_jnp,
        }
        params = {k: packers[k](v) if k in packers else v for k, v in params.items()}
    ctx = base_ctx._replace(**params)
    img = render_sequence_diff(seeds, state0, ctx, steps=steps, n_bins=n_bins)
    return jnp.mean((img - target) ** 2)


def make_spectral_inverse_step(optimizer, steps, n_bins,
                               clip_params=("density", "material_tf"),
                               grad_clip: float = 1e3):
    """Jitted Adam step for spectral inverse rendering (BASELINE config 4).

    state0/base_ctx are call arguments, not closure captures: large
    closed-over constants get serialized into the lowered module, which is
    pathologically slow on remote-compile toolchains (measured 426s vs 13s
    lowering for a 128^3 volume).

    ``grad_clip``: element-wise spike guard (sanitize_grads) against the
    score estimator's heavy tails; None disables.
    """

    @jax.jit
    def step(istate: InverseState, state0, base_ctx, seeds, target):
        loss, grads = jax.value_and_grad(spectral_render_loss)(
            istate.params, state0, base_ctx, seeds, target, steps, n_bins
        )
        if grad_clip is not None:
            grads = sanitize_grads(grads, grad_clip)
        updates, opt_state = optimizer.update(grads, istate.opt_state, istate.params)
        params = optax.apply_updates(istate.params, updates)
        for key in clip_params:
            if key in params:
                params = dict(params, **{key: jnp.clip(params[key], 0.0, 1.0)})
        return InverseState(params, opt_state, istate.step + 1), loss

    return step


def _pack_params_into_ctx(base_ctx, params: dict, raw_mtf=None, raw_light=None):
    """Corner-pack learned RAW tables into the base ctx's packed
    representation, in-graph (ops/interp.pack_*_jnp) — the PRB optimizer's
    analog of spectral_render_loss's pack_params. The representation always
    matches base_ctx (same PackedVolume kind / fused-TF layout), so the
    packed-adjoint backward dispatches identically every step.

    ``raw_mtf`` / ``raw_light``: raw fallbacks for the fused TF+light table
    when only one of the pair is learned."""
    from vpt_tpu.ops import interp

    updates = {}
    if "density" in params:
        base = base_ctx.density
        if isinstance(base, interp.PackedVolume):
            packer = (interp.pack_volume_corners_xy_jnp if base.kind == "xy"
                      else interp.pack_volume_corners_jnp)
            packed = packer(params["density"])
            updates["density"] = interp.PackedVolume(
                packed.reshape(-1, packed.shape[-1]), base.dims, base.kind)
        elif base.ndim == 4:
            packer = (interp.pack_volume_corners_xy_jnp if base.shape[-1] == 4
                      else interp.pack_volume_corners_jnp)
            updates["density"] = packer(params["density"])
        else:
            updates["density"] = params["density"]
    if "material_tf" in params or "light_spectrum" in params:
        if base_ctx.material_tf.shape[-1] == 18:
            mtf = params.get("material_tf", raw_mtf)
            light = params.get("light_spectrum", raw_light)
            if mtf is None or light is None:
                raise ValueError(
                    "fused-TF ctx needs raw_mtf/raw_light fallbacks when only "
                    "one of material_tf/light_spectrum is learned")
            updates["material_tf"] = interp.pack_tex2d_with_tex1d_jnp(mtf, light)
            if "light_spectrum" in params:
                updates["light_spectrum"] = interp.pack_tex1d_corners_jnp(light)
        else:
            if "material_tf" in params:
                updates["material_tf"] = params["material_tf"]
            if "light_spectrum" in params:
                updates["light_spectrum"] = params["light_spectrum"]
    if "extinction" in params:
        updates["extinction"] = params["extinction"]
    if "environment" in params:
        env = params["environment"]
        base_env = base_ctx.environment
        if base_env is not None and base_env.shape[-1] == 12:
            updates["environment"] = interp.pack_tex2d_corners_jnp(env)
        else:
            updates["environment"] = env
    return updates


def make_spectral_prb_step(optimizer, steps, n_bins,
                           wrt: frozenset,
                           scatter_stride: int = 1,
                           scatter_mode: str = "stride",
                           clip_params=("density", "material_tf"),
                           raw_mtf=None, raw_light=None,
                           grad_clip: float = 1e3):
    """Jitted Adam step on the hand-derived packed-adjoint PRB gradients
    (kernels/spectral_backward.prb_loss_and_grads) — the fast config-4 path.

    vs make_spectral_inverse_step (the autodiff REINFORCE surrogate): same
    estimator in expectation (identical event scores, score-form free
    flights), but the backward is one taped replay + one packed row scatter
    per table per lane-step instead of autodiff residuals — and
    ``scatter_stride`` thins the table scatters k-fold (unbiased, ~k x
    table-grad variance, phase rotating per dispatch). Requires a renderer
    built with pack_tables=True (the fused 18-wide TF + packed volume).
    ``wrt`` must cover every learned param key.
    """
    from vpt_tpu.kernels.spectral_backward import prb_loss_and_grads

    wrt = frozenset(wrt)

    @functools.partial(jax.jit, donate_argnames=("istate",))
    def step(istate: InverseState, state0, base_ctx, seeds, target):
        ctx = base_ctx._replace(**_pack_params_into_ctx(
            base_ctx, istate.params, raw_mtf=raw_mtf, raw_light=raw_light))
        _, _, loss, grads = prb_loss_and_grads(
            state0, ctx, seeds, target, steps, n_bins,
            wrt=wrt, scatter_stride=scatter_stride,
            scatter_mode=scatter_mode)
        grads = {k: grads[k] for k in istate.params}
        if grad_clip is not None:
            grads = sanitize_grads(grads, grad_clip)
        updates, opt_state = optimizer.update(grads, istate.opt_state,
                                              istate.params)
        params = optax.apply_updates(istate.params, updates)
        for key in clip_params:
            if key in params:
                params = dict(params, **{key: jnp.clip(params[key], 0.0, 1.0)})
        return InverseState(params, opt_state, istate.step + 1), loss

    return step


# --------------------------------------------------------------------------
# Adaptive scatter-stride policy. No FIXED stride is right: stride 4
# converges fastest on dense-gradient recoveries but STALLS on
# sparse-live-voxel recoveries (tools/convergence_stride.py; the
# wall-clock side of the trade is to be re-measured on the GPU). The
# policy has two arms:
#   1. a cheap structural probe at init — the fraction of voxels whose
#      density sits where the TF alpha has nonzero density-slope (the only
#      voxels the density gradient can touch). Sparse live fraction =>
#      thinning variance is concentrated => start at stride 1.
#   2. a runtime stall detector — a fixed-seed eval loss (deterministic in
#      params) checked every few iterations; if it stops improving while
#      thinned, anneal the stride to 1 (the study's own stall criterion).
# Calibration on the r4 study scenes (128^3, bench TF): sphere_in_cube
# f8-smoothed init 0.42, two_spheres f16 0.031, f8 0.055, sparse_spheres
# 0.002 — threshold 0.15 splits the measured regimes with wide margin.
# --------------------------------------------------------------------------
LIVE_FRACTION_STRIDE_THRESHOLD = 0.15


def live_gradient_fraction(density, tf_table, eps: float = 1e-6) -> float:
    """Fraction of voxels whose density lands on a TF row with nonzero
    alpha-slope along the density axis — the voxels a density gradient can
    reach through the TF chain (kernels/spectral_backward's
    d(value)/d(density) = row-difference slope; zero in clamp/flat zones).
    One cheap host-side pass over the raw tables."""
    import numpy as np

    tf = np.asarray(tf_table, np.float64)
    H = tf.shape[0]
    alpha = tf[..., 1]  # rows = density axis (sample_tex2d(mtf, t, dens))
    row_slope = np.abs(np.diff(alpha, axis=0)).max(axis=1)  # (H-1,)
    d = np.asarray(density, np.float64).ravel()
    r0 = np.clip(np.floor(d * H - 0.5).astype(np.int64), 0, H - 2)
    return float((row_slope[r0] > eps).mean())


def auto_initial_stride(init_density, tf_table, dense_stride: int = 4,
                        threshold: float = LIVE_FRACTION_STRIDE_THRESHOLD):
    """Initial scatter stride from the live-gradient-fraction probe:
    ``dense_stride`` when the gradient support is broad (thinning variance
    is MC-dominated and nearly free), 1 when it is concentrated.

    Prefer auto_initial_policy (below), which routes the concentrated
    regime to importance thinning instead of giving up the thinning win."""
    frac = live_gradient_fraction(init_density, tf_table)
    return (dense_stride if frac >= threshold else 1), frac


def auto_initial_policy(init_density, tf_table, stride: int = 4,
                        threshold: float = LIVE_FRACTION_STRIDE_THRESHOLD):
    """(scatter_mode, stride, live_fraction) for the adaptive estimator:

    - broad gradient support -> uniform stride thinning (cheapest
      selection; the k-fold table-grad variance is MC-dominated);
    - concentrated support -> IMPORTANCE thinning at the same index
      budget: per-lane step selection proportional to the actual
      per-table scatter magnitude — the scene class (two_spheres, f16
      smoothing) where uniform stride 4/8 stall
      (tools/convergence_stride.py).

    The runtime stall detector (EvalStallDetector) remains the safety
    net: on stall, fit_spectral anneals to the exact stride-1 estimator.
    """
    frac = live_gradient_fraction(init_density, tf_table)
    if frac >= threshold:
        return "stride", stride, frac
    return "importance", stride, frac


class EvalStallDetector:
    """Declares a stall when the fixed-seed eval loss fails to improve by
    ``rel_improve`` relative to the best seen, ``patience`` checks in a
    row — the wall-clock-to-threshold study's own stall criterion turned
    into a runtime guard."""

    def __init__(self, rel_improve: float = 0.02, patience: int = 2):
        self.rel_improve = rel_improve
        self.patience = patience
        self.best = float("inf")
        self.strikes = 0

    def update(self, eval_loss: float) -> bool:
        if eval_loss < self.best * (1.0 - self.rel_improve):
            self.best = eval_loss
            self.strikes = 0
        else:
            self.strikes += 1
        return self.strikes >= self.patience


def fit_spectral(
    target_image,
    renderer,
    camera,
    init_params: dict,
    dispatches_per_step: int = 8,
    iterations: int = 100,
    learning_rate: float = 0.02,
    seed: int = 0,
    progress=None,
    method: str | None = None,
    scatter_stride="auto",
    scatter_mode: str = "stride",
    checkpoint: str | None = None,
    checkpoint_every: int = 25,
    eval_every: int = 10,
    eval_dispatches: int = 16,
    return_info: bool = False,
):
    """Recover spectral-MCM scene parameters from a target HDR render.

    ``renderer``: an MCMSpectralRenderer. ``init_params``: subset of
    {density, material_tf, light_spectrum, extinction} as arrays.
    Fresh Monte-Carlo sample streams are drawn every iteration (stochastic
    gradients; the estimator's expectation matches the converged render).

    ``method``: "prb" runs the hand-derived packed-adjoint backward —
    requires pack_tables=True and honors ``scatter_stride`` (see
    make_spectral_prb_step). "autodiff" differentiates through
    the REINFORCE surrogate (render_sequence_diff) — works with raw or
    packed tables and arbitrary param subsets; the validation path.
    Default (None): "prb" when the renderer's tables are packed (the
    standard fast path), "autodiff" otherwise.

    ``scatter_stride``: "auto" (default) makes the estimator
    self-defending against the r4 finding that the thinning trade is
    scene-dependent: the live-gradient probe picks the initial
    (mode, stride) — uniform stride-4 thinning on broad gradient
    support, IMPORTANCE thinning at the same index budget on
    concentrated support (auto_initial_policy) — and while thinned a
    fixed-seed eval loss is checked every ``eval_every`` iterations; if
    it stalls (EvalStallDetector) the estimator anneals to the exact
    stride 1. An integer forces that stride (lowered to the largest
    divisor of ``steps`` with a warning when it does not divide; the
    effective policy is in ``info``), combined with ``scatter_mode``.

    ``checkpoint``: path for periodic (params, opt_state, step) snapshots
    (save_inverse_checkpoint); if the file already exists the run RESUMES
    from it — bit-identical to an uninterrupted run (per-iteration seeds
    derive from the iteration index; note "auto" annealing depends on
    eval history, which a resume replays deterministically only from the
    same checkpoint cadence). ``losses`` then covers only the resumed
    iterations.

    ``return_info``: additionally return a dict with the method, the
    probe's live fraction, the effective stride history, and the policy's
    eval-loss checks.
    """
    import os
    import warnings

    import numpy as np

    base_ctx = renderer.ctx(camera, seed)
    if method is None:
        packed = (base_ctx.material_tf.shape[-1] == 18
                  and (not hasattr(base_ctx.density, "ndim")
                       or base_ctx.density.ndim == 4))
        # super-voxel majorant mode (the sparse-scene accelerator) carries
        # its gradients through the autodiff surrogate;
        # the taped packed-PRB backward does not support it
        method = ("prb" if packed and base_ctx.majorant is None
                  else "autodiff")
    elif method == "prb" and base_ctx.majorant is not None:
        raise ValueError(
            "the packed-PRB backward does not support the super-voxel "
            "majorant mode; use method='autodiff' (the surrogate carries "
            "majorant-mode gradients)")
    state0 = renderer.reset(camera, seed)
    steps = renderer.config.steps
    n_bins = renderer.spectrum.n_bins

    params = {k: jnp.asarray(v) for k, v in init_params.items()}
    optimizer = optax.adam(learning_rate)
    istate = InverseState(params, optimizer.init(params), jnp.zeros((), jnp.int32))
    raw_mtf = jnp.asarray(renderer.material_tf.table)
    raw_light = jnp.asarray(renderer.light.spectrum_array())

    info = dict(method=method, live_fraction=None, stride_history=[],
                eval_checks=[])
    auto = scatter_stride == "auto"
    anneal_armed = False
    if method == "prb":
        if auto:
            probe_density = init_params.get("density", renderer.volume.density)
            probe_tf = np.asarray(
                init_params.get("material_tf", renderer.material_tf.table))
            scatter_mode, scatter_stride, frac = auto_initial_policy(
                probe_density, probe_tf)
            info["live_fraction"] = frac
            anneal_armed = scatter_stride > 1
        if steps % scatter_stride != 0:
            # the window backward partitions steps into stride phases; fall
            # back to the largest divisor of steps <= the requested stride so
            # user-settable steps (e.g. 6) keep working instead of crashing
            eff = max(d for d in range(1, scatter_stride + 1)
                      if steps % d == 0)
            warnings.warn(
                f"scatter_stride={scatter_stride} does not divide "
                f"steps={steps}; using the largest divisor {eff} "
                "(the effective estimator differs from the requested one)")
            scatter_stride = eff

        def make_step(stride, mode):
            return make_spectral_prb_step(
                optimizer, steps, n_bins, wrt=frozenset(params),
                scatter_stride=stride, scatter_mode=mode,
                raw_mtf=raw_mtf, raw_light=raw_light)

        step = make_step(scatter_stride, scatter_mode)
    elif method == "autodiff":
        scatter_stride = 1
        step = make_spectral_inverse_step(optimizer, steps, n_bins)
    else:
        raise ValueError(f"unknown method {method!r} (prb | autodiff)")
    info["stride_history"].append((0, f"{scatter_mode}:{scatter_stride}"
                                   if method == "prb" else "autodiff"))

    start = 0
    if checkpoint and os.path.exists(checkpoint):
        istate = load_inverse_checkpoint(checkpoint, istate)
        start = int(istate.step)

    target = jnp.asarray(target_image)

    eval_loss = None
    detector = None
    if anneal_armed:
        from vpt_tpu.models import mcm_spectral as M

        eval_seeds = jnp.asarray(
            [np.uint32((31337 + k) * 2654435761 % 2**32)
             for k in range(eval_dispatches)], jnp.uint32)

        @jax.jit
        def eval_loss(p):
            ctx = base_ctx._replace(**_pack_params_into_ctx(
                base_ctx, p, raw_mtf=raw_mtf, raw_light=raw_light))
            _, img = M.render_many(state0, ctx, eval_seeds, steps=steps,
                                   n_bins=n_bins)
            return jnp.mean((img - target) ** 2)

        detector = EvalStallDetector()

    losses = []
    for i in range(start, iterations):
        seeds = jnp.asarray(
            [np.uint32((seed + 1 + i * dispatches_per_step + k) * 2654435761 % 2**32)
             for k in range(dispatches_per_step)],
            jnp.uint32,
        )
        istate, loss = step(istate, state0, base_ctx, seeds, target)
        losses.append(float(loss))
        if anneal_armed and (i + 1) % eval_every == 0:
            ev = float(eval_loss(istate.params))
            info["eval_checks"].append((i + 1, ev))
            if detector.update(ev):
                warnings.warn(
                    f"eval loss stalled at iteration {i + 1} under "
                    f"{scatter_mode} thinning (stride {scatter_stride}); "
                    "annealing to the exact estimator (stride 1); the "
                    "thinning trade is scene-dependent "
                    "(tools/convergence_stride.py)")
                scatter_stride = 1
                scatter_mode = "stride"
                step = make_step(1, "stride")
                info["stride_history"].append((i + 1, "stride:1"))
                anneal_armed = False
        if progress is not None and (i % 10 == 0 or i == iterations - 1):
            progress(i, losses[-1])
        if checkpoint and ((i + 1) % checkpoint_every == 0
                           or i == iterations - 1):
            save_inverse_checkpoint(checkpoint, istate)
    info["final_stride"] = int(scatter_stride)
    if return_info:
        return istate.params, losses, info
    return istate.params, losses


def fit_density(
    target_images,
    cameras,
    init_density,
    tf_table,
    extinction: float = 100.0,
    slices: int = 32,
    resolution: int = 64,
    volume_filter: str = "linear",
    learn_tf: bool = False,
    iterations: int = 200,
    learning_rate: float = 0.05,
    mesh=None,
    progress=None,
):
    """Adam loop recovering density (and optionally the TF) from targets.

    ``target_images``: list of (H, W, 3) arrays; ``cameras``: matching list.
    Returns (params, losses).
    """
    import numpy as np

    static = dict(
        tf_table=jnp.asarray(tf_table),
        extinction=jnp.float32(extinction),
        slices=slices,
        resolution=resolution,
        volume_filter=volume_filter,
    )
    params = {"density": jnp.asarray(init_density)}
    if learn_tf:
        params["tf_table"] = jnp.asarray(tf_table)

    optimizer = optax.adam(learning_rate)
    state = InverseState(params, optimizer.init(params), jnp.zeros((), jnp.int32))
    step = make_inverse_step(optimizer, static, learn_tf)

    inv_mvps = [jnp.asarray(c.inverse_mvp()) for c in cameras]
    targets = [jnp.asarray(t) for t in target_images]
    if mesh is not None:
        from vpt_tpu.parallel.mesh import replicated, row_sharding

        targets = [
            jax.device_put(t, row_sharding(mesh, 3, 0)) for t in targets
        ]
        state = jax.tree.map(
            lambda x: jax.device_put(x, replicated(mesh)), state
        )

    losses = []
    for i in range(iterations):
        k = i % len(targets)
        offset = jnp.float32(_seed_to_offset(i))
        state, loss = step(state, inv_mvps[k], offset, targets[k])
        losses.append(float(loss))
        if progress is not None and (i % 20 == 0 or i == iterations - 1):
            progress(i, losses[-1])
    return state.params, np.asarray(losses)
