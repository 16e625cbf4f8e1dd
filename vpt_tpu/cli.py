"""vpt-tpu command line — this build's "application layer".

The reference's UI/dialog layer (Application.js + dialogs/) collapses into
this CLI + the typed config system: load a volume, pick a renderer and tone
mapper by the same string keys, render progressively to an image or an
animation, inspect registries, run inverse rendering.

Subcommands:
  render     progressive render to a PNG/NPY
  animate    turntable animation to a directory of PNGs
  renderers  list registered renderers (MainDialog.html:100-111 analog)
  tonemappers list registered tone mappers (:119-130 analog)
  info       environment/device report
  invert     inverse rendering: recover density from target renders
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load_volume(args):
    from vpt_tpu.scene.volume import Volume

    if args.volume == "sphere_in_cube":
        return Volume.sphere_in_cube(args.volume_size)
    if args.volume == "two_spheres":
        return Volume.two_spheres(args.volume_size)
    if args.volume.endswith(".bvp") or args.volume.endswith(".zip"):
        return Volume.from_bvp_file(args.volume)
    if args.volume.endswith(".raw"):
        assert args.dims, "--dims WxHxD required for .raw volumes"
        w, h, d = (int(x) for x in args.dims.split("x"))
        return Volume.from_raw_file(args.volume, w, h, d)
    if args.volume.endswith(".npy"):
        import numpy as np

        return Volume(density=np.load(args.volume).astype(np.float32))
    raise SystemExit(f"unrecognized volume: {args.volume}")


def _load_envmap(args):
    """Load an equirect environment map image -> (H, W, 3) float [0,1]."""
    if not getattr(args, "envmap", None):
        return None
    import numpy as np

    if args.envmap.endswith(".npy"):
        img = np.load(args.envmap)
    else:
        from PIL import Image

        img = np.asarray(Image.open(args.envmap).convert("RGB"))
    img = np.asarray(img, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    return img[..., :3]


def _make_mesh(args):
    """--devices N -> a "rays" device mesh (None = single device)."""
    n = getattr(args, "devices", None)
    if not n or n <= 1:
        return None
    from vpt_tpu.parallel.mesh import ray_mesh

    return ray_mesh(n)


def _make_session(args):
    from vpt_tpu.session import RenderSession
    from vpt_tpu.utils.config import (
        LightConfig, MaterialTF, MCMConfig, MCMSpectralConfig, SpectrumConfig,
        EAMConfig,
    )
    import numpy as np

    volume = _load_volume(args)
    key = args.renderer
    if getattr(args, "compaction", False) and key not in ("mcm-spectral", "mcm"):
        # fail at the CLI layer with a clear message instead of
        # silently ignoring the flag for renderers without a compact mode
        raise SystemExit(
            f"--compaction is supported by mcm-spectral and mcm, not {key!r}")

    if key == "mcm-spectral":
        table = np.zeros((256, 256, 4), np.float32)
        dens = np.linspace(0, 1, 256)[:, None]
        table[..., 0] = 0.9
        table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
        table[..., 2] = 0.5
        material = (MaterialTF.from_uint8(np.load(args.material))
                    if args.material else MaterialTF(table))
        sess = RenderSession(
            key, volume, material,
            LightConfig(direction=tuple(args.light)),
            SpectrumConfig.uniform(args.bins),
            MCMSpectralConfig(extinction=args.extinction, bounces=args.bounces,
                              steps=args.steps),
            tonemapper=args.tonemapper, resolution=args.resolution,
            base_seed=args.seed, streams=args.streams,
            environment=_load_envmap(args),
            majorant_blocks=args.majorant_blocks,
            mesh=_make_mesh(args),
            compaction=args.compaction,
        )
    elif key == "mcm":
        sess = RenderSession(
            key, volume, None, _load_envmap(args),
            MCMConfig(extinction=args.extinction, bounces=args.bounces,
                      steps=args.steps),
            tonemapper=args.tonemapper, resolution=args.resolution,
            base_seed=args.seed, compaction=args.compaction,
        )
    elif key == "eam":
        sess = RenderSession(
            key, volume, None, EAMConfig(extinction=args.extinction),
            tonemapper=args.tonemapper, resolution=args.resolution,
            base_seed=args.seed,
        )
    else:
        sess = RenderSession(
            key, volume, tonemapper=args.tonemapper,
            resolution=args.resolution, base_seed=args.seed,
        )
    if args.orbit:
        from vpt_tpu.scene.camera import OrbitController

        yaw, pitch, dist = args.orbit
        orbit = OrbitController(yaw=yaw, pitch=pitch, focus_distance=dist)
        orbit.apply(sess.camera)
        sess.reset()
    return sess


def _save_image(img_u8, path):
    if path.endswith(".npy"):
        import numpy as np

        np.save(path, img_u8)
        return
    try:
        from PIL import Image

        Image.fromarray(img_u8).save(path)
    except ImportError:
        import numpy as np

        np.save(path + ".npy", img_u8)
        print(f"PIL unavailable; wrote {path}.npy instead", file=sys.stderr)


def cmd_render(args):
    sess = _make_session(args)
    t0 = time.perf_counter()
    sess.run(args.frames)
    metrics = sess.metrics()
    metrics["wall_seconds"] = time.perf_counter() - t0
    _save_image(sess.image_u8(), args.output)
    print(json.dumps(metrics))
    print(f"wrote {args.output}", file=sys.stderr)
    if args.checkpoint:
        sess.save_checkpoint(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)


def cmd_animate(args):
    import os

    from vpt_tpu.scene.camera import CircleAnimator

    sess = _make_session(args)
    os.makedirs(args.output, exist_ok=True)
    anim = CircleAnimator(
        center=[0.0, 0.0, args.orbit[2] if args.orbit else 2.0],
        radius=args.radius,
    )
    frames = sess.record_animation(
        anim, n_frames=args.n_frames, frames_per_pose=args.frames,
        progress=lambda p: print(f"\r{p:4.0%}", end="", file=sys.stderr),
    )
    for i, f in enumerate(frames):
        _save_image(f, os.path.join(args.output, f"frame_{i:04d}.png"))
    print(f"\nwrote {len(frames)} frames to {args.output}", file=sys.stderr)


def cmd_renderers(_args):
    from vpt_tpu.models import RENDERERS

    for key in sorted(RENDERERS):
        print(key)


def cmd_tonemappers(_args):
    from vpt_tpu.postprocess.tonemap import TONEMAPPERS

    for key in sorted(TONEMAPPERS):
        print(key)


def cmd_info(_args):
    import jax

    from vpt_tpu.scene import native_io

    print(json.dumps({
        "jax": jax.__version__,
        "devices": [str(d) for d in jax.devices()],
        "default_backend": jax.default_backend(),
        "native_io": native_io.available(),
    }, indent=2))


def cmd_invert(args):
    import numpy as np

    from vpt_tpu.optim import fit_density
    from vpt_tpu.scene.camera import Camera, OrbitController
    from vpt_tpu.models.raymarch import eam_frame
    import jax.numpy as jnp

    if args.spectral:
        return _cmd_invert_spectral(args)
    target_vol = _load_volume(args)
    tf = np.zeros((256, 256, 4), np.float32)
    tf[..., :3] = 1.0
    tf[..., 3] = np.linspace(0, 1, 256)[None, :]

    cameras = []
    for k in range(args.views):
        cam = Camera()
        OrbitController(yaw=2 * np.pi * k / args.views, pitch=-0.4).apply(cam)
        cameras.append(cam)
    targets = [
        np.asarray(eam_frame(
            jnp.asarray(c.inverse_mvp()), jnp.asarray(target_vol.density),
            jnp.asarray(tf), jnp.float32(args.extinction), jnp.float32(0.0),
            slices=32, resolution=args.resolution,
        ))
        for c in cameras
    ]
    D = target_vol.density.shape[0]
    params, losses = fit_density(
        targets, cameras, np.full((D, D, D), 0.2, np.float32), tf,
        extinction=args.extinction, slices=32, resolution=args.resolution,
        iterations=args.iterations,
        progress=lambda i, l: print(f"iter {i}: loss {l:.6f}", file=sys.stderr),
    )
    np.save(args.output, np.asarray(params["density"]))
    err = float(np.abs(np.asarray(params["density"]) - target_vol.density).mean())
    print(json.dumps({"final_loss": losses[-1], "density_mae": err}))


def _cmd_invert_spectral(args):
    """Spectral-MCM inverse rendering (BASELINE config 4) on the packed-PRB
    fast path: recover the density grid from a converged spectral render.
    ``--method prb --scatter-stride 4`` is the thinned estimator
    (tools/convergence_stride.py measures the trade); ``--method autodiff``
    is the REINFORCE-surrogate validation path."""
    import numpy as np

    from vpt_tpu.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu.optim import fit_spectral
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import (
        LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig,
    )

    target_vol = _load_volume(args)
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5

    def renderer(vol):
        return MCMSpectralRenderer(
            vol, MaterialTF(table), LightConfig(direction=(0.0, 0.0, 0.0)),
            SpectrumConfig(),
            MCMSpectralConfig(extinction=args.extinction, bounces=8, steps=8),
            resolution=args.resolution, streams=4, pack_tables=True)

    cam = Camera()
    r_true = renderer(target_vol)
    state = r_true.reset(cam, 999)
    state, target = r_true.render_many(
        state, cam, [(999 + k) * 2654435761 % 2**32 for k in range(128)])

    # heavily smoothed init preserving gross structure
    d = np.asarray(target_vol.density)
    f = max(d.shape[0] // 16, 4)
    n = d.shape[0]
    c = d[: n // f * f, : n // f * f, : n // f * f].reshape(
        n // f, f, n // f, f, n // f, f).mean(axis=(1, 3, 5))
    init = np.repeat(np.repeat(np.repeat(c, f, 0), f, 1), f, 2)
    init = np.pad(init, [(0, n - init.shape[i]) for i in range(3)],
                  mode="edge").astype(np.float32)

    params, losses = fit_spectral(
        np.asarray(target), renderer(Volume(density=init)), cam,
        {"density": init}, iterations=args.iterations,
        method=args.method, scatter_stride=args.scatter_stride,
        scatter_mode=args.scatter_mode,
        progress=lambda i, l: print(f"iter {i}: loss {l:.6f}",
                                    file=sys.stderr))
    rec = np.asarray(params["density"])
    np.save(args.output, rec)
    err = float(np.abs(rec - np.asarray(target_vol.density)).mean())
    init_err = float(np.abs(init - np.asarray(target_vol.density)).mean())
    print(json.dumps({"final_loss": losses[-1], "density_mae": err,
                      "init_density_mae": init_err}))


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="vpt-tpu",
        description="Differentiable spectral volume path tracing")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--volume", default="sphere_in_cube")
        sp.add_argument("--volume-size", type=int, default=64)
        sp.add_argument("--dims", help="WxHxD for .raw volumes")
        sp.add_argument("--renderer", default="mcm-spectral")
        sp.add_argument("--tonemapper", default="artistic")
        sp.add_argument("--resolution", type=int, default=512)
        sp.add_argument("--frames", type=int, default=64)
        sp.add_argument("--steps", type=int, default=8)
        sp.add_argument("--bounces", type=int, default=8)
        sp.add_argument("--bins", type=int, default=12)
        sp.add_argument("--extinction", type=float, default=40.0)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--light", type=float, nargs=3, default=[1.0, 0.2, 0.5])
        sp.add_argument("--material", help=".npy uint8 (256,256,4) material TF")
        sp.add_argument("--envmap", help="equirect environment image (PNG/NPY) for mcm/mcs/mcm-spectral")
        sp.add_argument("--streams", type=int, default=1,
                        help="parallel sample streams per pixel (mcm-spectral)")
        sp.add_argument("--compaction", action="store_true",
                        help="hit-lane compaction (mcm-spectral/mcm, "
                             "blur=0): march only pixels that can hit the "
                             "cube; miss pixels take the closed-form value "
                             "— light spectrum or env-map quadrature "
                             "(~1.75x at the default pose)")
        sp.add_argument("--majorant-blocks", type=int, default=None,
                        help="super-voxel majorant grid block size in voxels "
                             "(mcm-spectral; statistically exact empty-space "
                             "skipping for sparse scenes)")
        sp.add_argument("--devices", type=int, default=None,
                        help="shard the render over the first N devices "
                             "(a 1-D 'rays' mesh; mcm-spectral)")
        sp.add_argument("--orbit", type=float, nargs=3,
                        metavar=("YAW", "PITCH", "DIST"))

    sp = sub.add_parser("render", help="progressive render to an image")
    common(sp)
    sp.add_argument("--output", "-o", default="render.png")
    sp.add_argument("--checkpoint")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("animate", help="turntable animation")
    common(sp)
    sp.add_argument("--output", "-o", default="animation")
    sp.add_argument("--n-frames", type=int, default=24)
    sp.add_argument("--radius", type=float, default=0.5)
    sp.set_defaults(fn=cmd_animate)

    sp = sub.add_parser("renderers")
    sp.set_defaults(fn=cmd_renderers)
    sp = sub.add_parser("tonemappers")
    sp.set_defaults(fn=cmd_tonemappers)
    sp = sub.add_parser("info")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("invert", help="inverse rendering demo")
    common(sp)
    sp.add_argument("--output", "-o", default="recovered.npy")
    sp.add_argument("--views", type=int, default=4)
    sp.add_argument("--iterations", type=int, default=200)
    sp.add_argument("--spectral", action="store_true",
                    help="spectral-MCM inverse on the packed-PRB fast path")
    sp.add_argument("--method", choices=["prb", "autodiff"], default=None,
                    help="gradient estimator (default: auto)")
    sp.add_argument("--scatter-stride", default="auto",
                    type=lambda s: s if s == "auto" else int(s),
                    help="PRB scatter thinning stride (unbiased); 'auto' "
                         "probes the live-gradient fraction (stride vs "
                         "importance thinning) and anneals to exact on "
                         "eval-loss stall (optim.fit_spectral)")
    sp.add_argument("--scatter-mode", choices=["stride", "importance"],
                    default="stride",
                    help="thinning step selection for a FORCED integer "
                         "stride: uniform phase vs importance (by scatter "
                         "magnitude); ignored under --scatter-stride auto")
    sp.set_defaults(fn=cmd_invert)

    args = p.parse_args(argv)
    from vpt_tpu.utils.runtime import init_compile_cache

    init_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
