"""Config-4 convergence evidence: loss vs WALL-CLOCK for the spectral
inverse-rendering step across gradient estimators.

Curves (same scene, same targets, same seed sequence, density-only):
  - autodiff   : REINFORCE-surrogate autodiff (optim.make_spectral_inverse_step)
  - prb-s1/2/4 : hand-derived packed-adjoint PRB (optim.make_spectral_prb_step)
                 at scatter_stride 1 / 2 / 4

The decisive metric is the EVAL loss — MSE of a fixed-seed render estimate of
the current params against the target, computed OFF the optimizer clock every
iteration. It is deterministic given params (identical eval seeds for every
method/iteration), so curves compare exactly; the training loss (per-window
MC MSE) and parameter-space density MSE are recorded alongside (the latter is
confounded at a single view: occluded/interior voxels are unconstrained, so
image-space convergence need not move it). Results go to
tools/convergence_stride.json.

Rationale: scatter_stride=k thins table scatters k-fold — an unbiased
estimator with ~k x table-grad variance. Whether that buys wall-clock
depends on what scatters cost on the device; this script is the
measurement.

Run: python tools/convergence_stride.py [--res 256] [--iters 60]
"""

import argparse
import json
import time

import numpy as np


def _scene(resolution, volume_density, steps, streams):
    from vpt_tpu.models import mcm_spectral as M
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import (
        LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig,
    )

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    return M.MCMSpectralRenderer(
        Volume(density=volume_density),
        MaterialTF(table),
        LightConfig(direction=(1.0, 0.2, 0.5)),
        SpectrumConfig(),
        MCMSpectralConfig(extinction=40.0, bounces=8, steps=steps),
        resolution=resolution,
        streams=streams,
    )


def _smoothed(density, factor=8):
    """Blockwise-mean downsample + nearest upsample: a heavily smoothed
    init that preserves gross structure (the recovery task)."""
    d = np.asarray(density, np.float32)
    n = d.shape[0]
    c = d.reshape(n // factor, factor, n // factor, factor,
                  n // factor, factor).mean(axis=(1, 3, 5))
    up = np.repeat(np.repeat(np.repeat(c, factor, 0), factor, 1), factor, 2)
    return np.ascontiguousarray(up, np.float32)


def run_curve(kind, stride, true_density, init_density, target, resolution,
              steps, streams, iterations, dispatches_per_step, lr, seed,
              mode="stride"):
    import jax
    import jax.numpy as jnp
    import optax

    from vpt_tpu import optim
    from vpt_tpu.scene.camera import Camera

    renderer = _scene(resolution, init_density, steps, streams)
    cam = Camera()
    base_ctx = renderer.ctx(cam, seed)
    state0 = renderer.reset(cam, seed)
    n_bins = renderer.spectrum.n_bins

    params = {"density": jnp.asarray(init_density)}
    optimizer = optax.adam(lr)

    def prb_step(s, m=None):
        return optim.make_spectral_prb_step(
            optimizer, steps, n_bins, wrt=frozenset({"density"}),
            scatter_stride=s, scatter_mode=m or mode)

    stride_switches = []
    if kind == "autodiff":
        step = optim.make_spectral_inverse_step(optimizer, steps, n_bins)
    elif kind == "auto":
        # the SHIPPED policy (optim.fit_spectral scatter_stride="auto"):
        # (mode, stride) from the live-gradient probe — uniform stride
        # thinning on broad support, importance thinning on concentrated
        # support — anneal to exact stride 1 on eval-loss stall. Policy
        # evals run ON the clock (they are part of the estimator's cost);
        # the off-clock metric eval is separate.
        table = np.zeros((256, 256, 4), np.float32)
        dens = np.linspace(0, 1, 256)[:, None]
        table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
        mode, stride, frac = optim.auto_initial_policy(init_density, table)
        print(f"# auto: live fraction {frac:.4f} -> {mode}:{stride}")
        stride_switches.append((0, f"{mode}:{stride}"))
        step = prb_step(stride, mode)
    else:
        stride = stride
        step = prb_step(stride)

    def seeds_for(i):
        return jnp.asarray(
            [np.uint32((seed + 1 + i * dispatches_per_step + k)
                       * 2654435761 % 2**32)
             for k in range(dispatches_per_step)], jnp.uint32)

    tgt = jnp.asarray(target)

    # fixed-seed eval estimator (the decisive metric; OFF the clock).
    # Deterministic in params: same eval seeds for every method/iteration.
    from vpt_tpu.models import mcm_spectral as M
    from vpt_tpu.optim import _pack_params_into_ctx

    eval_seeds = jnp.asarray(
        [np.uint32((31337 + k) * 2654435761 % 2**32) for k in range(16)],
        jnp.uint32)

    @jax.jit
    def eval_loss(params):
        ctx = base_ctx._replace(**_pack_params_into_ctx(base_ctx, params))
        _, img = M.render_many(state0, ctx, eval_seeds, steps=steps,
                               n_bins=n_bins)
        return jnp.mean((img - tgt) ** 2)

    # warm the compiles outside the clock (for "auto", warm the stride-1
    # step too — the anneal switch's one-time compile is excluded like
    # every other compile in this tool)
    warm = optim.InverseState(params, optimizer.init(params),
                              jnp.zeros((), jnp.int32))
    warm, wl = step(warm, state0, base_ctx, seeds_for(10**6), tgt)
    float(wl)
    float(eval_loss(warm.params))
    step_s1 = None
    if kind == "auto" and stride > 1:
        step_s1 = prb_step(1)
        # fresh arrays: the prb step DONATES istate, so `params`' buffers
        # were consumed by the first warm call above
        p1 = {"density": jnp.asarray(init_density)}
        warm1 = optim.InverseState(p1, optimizer.init(p1),
                                   jnp.zeros((), jnp.int32))
        warm1, wl1 = step_s1(warm1, state0, base_ctx, seeds_for(10**6), tgt)
        float(wl1)

    detector = optim.EvalStallDetector() if kind == "auto" else None
    eval_every = 10

    istate = optim.InverseState(
        {"density": jnp.asarray(init_density)},
        optimizer.init({"density": jnp.asarray(init_density)}),
        jnp.zeros((), jnp.int32))
    init_eval = float(eval_loss(istate.params))
    times, train_loss, eval_losses, dens_mse = [], [], [], []
    elapsed = 0.0
    for i in range(iterations):
        t0 = time.perf_counter()
        istate, loss = step(istate, state0, base_ctx, seeds_for(i), tgt)
        lv = float(loss)  # sync
        if kind == "auto" and stride > 1 and (i + 1) % eval_every == 0:
            # the policy's stall check is part of the estimator: ON clock
            if detector.update(float(eval_loss(istate.params))):
                stride = 1
                step = step_s1
                stride_switches.append((i + 1, "stride:1"))
                print(f"# auto: eval stall -> stride 1 at iter {i + 1}")
        elapsed += time.perf_counter() - t0
        times.append(round(elapsed, 4))
        train_loss.append(lv)
        # metric fetches OFF the clock
        eval_losses.append(float(eval_loss(istate.params)))
        d = np.asarray(istate.params["density"])
        dens_mse.append(float(np.mean((d - true_density) ** 2)))
    name = {"autodiff": "autodiff", "auto": "auto"}.get(
        kind, f"prb-{'i' if mode == 'importance' else 's'}{stride}")
    out = dict(method=name,
               times=times, train_loss=train_loss, eval_loss=eval_losses,
               init_eval_loss=init_eval, density_mse=dens_mse)
    if kind == "auto":
        out["stride_switches"] = stride_switches
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--volume", type=int, default=128)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--dispatches", type=int, default=8)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--target-dispatches", type=int, default=256)
    ap.add_argument("--scene", default="sphere_in_cube",
                    choices=["sphere_in_cube", "two_spheres",
                             "sparse_spheres"],
                    help="recovery scene (replicate the "
                         "study beyond one scene)")
    ap.add_argument("--seed", type=int, default=7,
                    help="optimizer sample-stream seed (replicates)")
    ap.add_argument("--init-factor", type=int, default=8,
                    help="smoothing block size of the init (larger = harder "
                         "recovery; two_spheres at the default 8 renders "
                         "nearly like the truth — gap too small to "
                         "discriminate methods)")
    ap.add_argument("--methods",
                    default="autodiff,prb-s1,prb-s2,prb-s4,prb-s8,auto",
                    help="comma list from {autodiff, prb-sK, prb-iK, auto}; "
                         "auto = the shipped adaptive policy (probe + stall "
                         "anneal); prb-iK = importance-thinned scatters at "
                         "stride-K's index budget")
    ap.add_argument("--out", default=None,
                    help="default: tools/convergence_stride.json for the "
                         "primary (sphere_in_cube seed 7), else "
                         "tools/convergence_stride_<scene>_s<seed>.json")
    args = ap.parse_args()
    if args.out is None:
        if args.scene == "sphere_in_cube" and args.seed == 7:
            args.out = "tools/convergence_stride.json"
        else:
            f = ("" if args.init_factor == 8
                 else f"_f{args.init_factor}")
            args.out = (f"tools/convergence_stride_{args.scene}"
                        f"{f}_s{args.seed}.json")

    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume

    if args.scene == "sparse_spheres":
        vol = Volume.sparse_spheres(args.volume)
    else:
        vol = getattr(Volume, args.scene)(args.volume)
    true_density = np.asarray(vol.density, np.float32)
    init_density = _smoothed(true_density, factor=args.init_factor)

    # converged target render of the TRUE scene
    renderer = _scene(args.res, true_density, args.steps, args.streams)
    cam = Camera()
    state = renderer.reset(cam, 999)
    tseeds = [(999 + k + 1) * 2654435761 % 2**32
              for k in range(args.target_dispatches)]
    state, target = renderer.render_many(state, cam, tseeds)
    target = np.asarray(target)
    print(f"# target: {args.target_dispatches} dispatches, "
          f"mean {target.mean():.4f}")

    init_mse = float(np.mean((init_density - true_density) ** 2))
    print(f"# init density MSE {init_mse:.6f}")

    rows = []
    # stride 8 = one scattered step per 8-step dispatch; the k%stride phase
    # covers uniformly because dispatches_per_step (8) is a multiple
    wanted = [m.strip() for m in args.methods.split(",") if m.strip()]
    plan = []
    for m in wanted:
        if m == "autodiff":
            plan.append(("autodiff", 0))
        elif m == "auto":
            plan.append(("auto", 0))
        elif m.startswith("prb-s"):
            plan.append(("prb", int(m[len("prb-s"):])))
        elif m.startswith("prb-i"):
            # importance-thinned scatters at the same index budget as
            # stride K
            plan.append(("prb-imp", int(m[len("prb-i"):])))
        else:
            raise SystemExit(f"unknown method {m!r}")
    for kind, stride in plan:
        mode = "importance" if kind == "prb-imp" else "stride"
        r = run_curve("prb" if kind == "prb-imp" else kind, stride,
                      true_density, init_density, target,
                      args.res, args.steps, args.streams, args.iters,
                      args.dispatches, args.lr, seed=args.seed, mode=mode)
        r["init_density_mse"] = init_mse
        rows.append(r)
        print(f"# {r['method']}: {r['times'][-1]:.1f}s, "
              f"eval loss {r['init_eval_loss']:.6f} -> "
              f"{r['eval_loss'][-1]:.6f}, "
              f"density MSE {init_mse:.5f} -> {r['density_mse'][-1]:.5f}, "
              f"train loss {r['train_loss'][0]:.5f} -> "
              f"{r['train_loss'][-1]:.5f}")

    with open(args.out, "w") as f:
        json.dump(dict(
            config=dict(res=args.res, volume=args.volume, iters=args.iters,
                        dispatches=args.dispatches, streams=args.streams,
                        steps=args.steps, lr=args.lr, scene=args.scene,
                        seed=args.seed, init_factor=args.init_factor),
            curves=rows), f)
    print(f"wrote {args.out}")

    # time-to-threshold summary (the decisive numbers): wall-clock to reach
    # a given fraction of the initial eval-loss GAP above the noise floor
    # (floor = best eval loss any method reached — eval vs target MSE cannot
    # reach 0: both are finite-spp estimates).
    floor = min(min(r["eval_loss"]) for r in rows)
    init_eval = rows[0]["init_eval_loss"]
    print(f"# eval-loss floor {floor:.6f}, init {init_eval:.6f}")
    for frac in (0.5, 0.25, 0.1):
        thresh = floor + (init_eval - floor) * frac
        line = [f"eval-loss gap <= {frac:.2f}x init:"]
        for r in rows:
            hit = next((t for t, m in zip(r["times"], r["eval_loss"])
                        if m <= thresh), None)
            line.append(f"{r['method']}={'%.1fs' % hit if hit else 'never'}")
        print("  ".join(line))


if __name__ == "__main__":
    main()
