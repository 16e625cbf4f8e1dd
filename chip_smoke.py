"""Bring-up check: the spectral path tracer's main path on an NVIDIA GPU.

Drives the entry points users call (RenderSession, make_renderer,
prb_render_and_grads_many, fit_spectral), at the sizes they run, and
checks every result. One process owns the card(s).

    python chip_smoke.py               # one card: phases 1-7
    python chip_smoke.py --devices 4   # only the multi-card paths

Phases on one card:
  1. device check: a GPU, its name and power limit, the compile cache
  2. u8 packed-table sampling bit-exact on the card
  3. forward at upstream VPT's settings (128^3 u8 sphere_in_cube, 512^2,
     8 steps, 8 bounces, 12 bins, 64 dispatches) against the same jitted
     program on the host CPU, same seeds
  4. fwd+bwd (packed-adjoint PRB) at the bench shape, stride 1 and 4; at
     a reduced size, PRB gradients against autodiff of the surrogate
  5. inverse fit of a 128^3 density at 256^2
  6. a 512^3 u8 volume held whole, rendered at 1024^2
  7. all nine renderers, one dispatch each at 512^2 on 128^3

With ``--devices 4``: rays-mesh render (4 cards vs 1), slab render and
slab gradients against the replicated ones, one slab fit step at 512^3.

Each phase prints one line with its result, compile time, steady wall
time and the process's peak device memory so far. A failed check exits
non-zero; no phase is skipped. The last line of standard output is one
JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from vpt_tpu.utils.profiling import timed

# Tolerance for a gradient computed two ways on the card, as a fraction of
# the reference's largest magnitude: the CPU suite's own bound for PRB vs
# autodiff (tests/test_prb_packed.py). GPU scatter-adds are atomics whose
# summation order changes from run to run; reordering f32 sums moves them
# by ~1e-6 of that scale, far inside this bound.
GRAD_TOL = 5e-4

# Monte-Carlo image comparison: relative L1 must stay under this many times
# the CPU's own seed-to-seed noise floor, plus a small absolute slack (the
# rule of tools/capability_configs.config_sparse). At 64 dispatches the
# one-hot 12-bin estimator leaves per-pixel noise near the image's own
# magnitude, so the rule is also applied to 16x16-pixel block means, whose
# floor is ~16x lower and which a structurally wrong image cannot meet.
L1_FLOOR_FACTOR = 2.0
L1_SLACK = 1e-3
BLOCK = 16


def _material():
    """The density-ramp material of bench.py and the CLI."""
    from vpt_tpu.utils.config import MaterialTF

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    return MaterialTF(table)


def _spectral_session(volume, resolution, steps=8, streams=1, mesh=None):
    from vpt_tpu.session import RenderSession
    from vpt_tpu.utils.config import (
        LightConfig, MCMSpectralConfig, SpectrumConfig,
    )

    return RenderSession(
        "mcm-spectral", volume, _material(),
        LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
        MCMSpectralConfig(extinction=40.0, bounces=8, steps=steps),
        resolution=resolution, streams=streams, mesh=mesh)


def _rel_l1(a, b):
    return float(np.abs(a - b).mean()) / max(float(np.abs(b).mean()), 1e-12)


def _block_means(img):
    h, w, c = img.shape
    return img.reshape(h // BLOCK, BLOCK, w // BLOCK, BLOCK, c).mean((1, 3))


def _grad_err(got, ref):
    """max |got - ref| over max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-12)


class _IterationClock:
    """``progress`` callback of the fit loops: the first report (iteration
    0, which waits on its loss) closes the compile-and-first-step time;
    the last one gives the steady time per iteration."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.marks = []

    def __call__(self, i, loss):
        self.marks.append((i, time.perf_counter()))

    def times(self):
        (i0, t0), (i1, t1) = self.marks[0], self.marks[-1]
        return dict(compile_s=t0 - self.t0,
                    steady_s_per_iteration=(t1 - t0) / max(i1 - i0, 1))


def _seeds(base, k):
    return [(base + i) * 2654435761 % 2**32 for i in range(k)]


# -- phases on one card ----------------------------------------------------

def phase_u8_exact():
    from bench import check_u8_bit_exact

    ok, compile_s = timed(check_u8_bit_exact)
    again, steady_s = timed(check_u8_bit_exact)
    return dict(ok=bool(ok and again), u8_bit_exact=bool(ok and again),
                compile_s=compile_s, steady_s=steady_s)


def phase_forward(volume_size=128, resolution=512, dispatches=64):
    """session.run on the card vs the same program on the host CPU."""
    import jax
    import jax.numpy as jnp

    from vpt_tpu.models import mcm_spectral as M
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.session import frame_seed

    sess = _spectral_session(Volume.sphere_in_cube(volume_size), resolution)
    r, cam = sess.renderer, sess.camera
    steps, n_bins, filt = r.config.steps, r.spectrum.n_bins, r.volume.filter

    t0 = time.perf_counter()
    sess.run(dispatches)
    compile_s = time.perf_counter() - t0
    gpu = sess.hdr_image()
    sess.reset()
    t0 = time.perf_counter()
    sess.run(dispatches)
    steady_s = time.perf_counter() - t0
    rerun_identical = bool((sess.hdr_image() == gpu).all())

    cpu = jax.devices("cpu")[0]
    seeds = [frame_seed(sess.base_seed, 1 + k) for k in range(dispatches)]

    def on_cpu(tree):
        return jax.device_put(tree, cpu)

    def cpu_many(seed_list):
        state = on_cpu(r.reset(cam, frame_seed(sess.base_seed, 0)))
        ctx = on_cpu(r.ctx(cam, seed_list[0]))
        s = on_cpu(jnp.asarray(np.asarray(seed_list, np.uint32)))
        _, img = M.render_many(state, ctx, s, steps=steps, n_bins=n_bins,
                               volume_filter=filt)
        return np.asarray(img)

    # one dispatch, same seed, card vs CPU: per-pixel identity
    state = r.reset(cam, frame_seed(sess.base_seed, 0))
    ctx = r.ctx(cam, seeds[0])
    _, one_gpu = M.render(state, ctx, steps=steps, n_bins=n_bins,
                          volume_filter=filt)
    _, one_cpu = M.render(on_cpu(r.reset(cam, frame_seed(sess.base_seed, 0))),
                          on_cpu(ctx), steps=steps, n_bins=n_bins,
                          volume_filter=filt)
    identical = float(np.all(np.asarray(one_gpu) == np.asarray(one_cpu),
                             axis=-1).mean())

    ref = cpu_many(seeds)
    other = cpu_many([s ^ 0x9E3779B9 for s in seeds])
    l1 = {}
    for name, f in (("pixels", np.asarray), ("blocks", _block_means)):
        floor = _rel_l1(f(other), f(ref))
        l1[name] = dict(rel_l1_vs_cpu=_rel_l1(f(gpu), f(ref)),
                        cpu_seed_floor=floor,
                        bound=L1_FLOOR_FACTOR * floor + L1_SLACK)
    ok = bool(np.isfinite(gpu).all() and gpu.shape == (resolution,
                                                        resolution, 3)
              and all(v["rel_l1_vs_cpu"] < v["bound"] for v in l1.values())
              and rerun_identical)
    return dict(ok=ok, dispatches=dispatches,
                bit_identical_pixels_1_dispatch=identical, **l1,
                rerun_bit_identical=rerun_identical,
                compile_s=compile_s, steady_s=steady_s,
                mpaths_per_s=(float(np.asarray(sess.state.samples).sum())
                              / steady_s / 1e6))


def phase_fwdbwd(volume_size=128, resolution=512, streams=4, window=4):
    """prb_render_and_grads_many at the bench shape, stride 1 and 4."""
    import jax.numpy as jnp

    from bench import _scene
    from vpt_tpu.kernels.spectral_backward import prb_render_and_grads_many

    renderer, cam = _scene(resolution, volume_size, 8, streams)
    ctx = renderer.ctx(cam, 1)
    g_img = jnp.ones((resolution, resolution, 3), jnp.float32)
    seeds = jnp.asarray(_seeds(2, window), jnp.uint32)
    out = dict(ok=True)
    for stride in (1, 4):
        def call():
            return prb_render_and_grads_many(
                renderer.reset(cam, 1), ctx, seeds, g_img, 8, 12,
                wrt=frozenset({"density"}), scatter_stride=stride)

        _, compile_s = timed(call)
        (_, img, g), steady_s = timed(call)
        g = np.asarray(g["density"])
        ok = bool(np.isfinite(g).all() and np.abs(g).max() > 0
                  and np.isfinite(np.asarray(img)).all()
                  and g.shape == (volume_size,) * 3)
        out["ok"] &= ok
        out[f"stride{stride}"] = dict(ok=ok, compile_s=compile_s,
                                      steady_s=steady_s,
                                      grad_abs_max=float(np.abs(g).max()))
    out.update(prb_vs_autodiff())
    out["ok"] &= out["prb_vs_autodiff_ok"]
    return out


def prb_vs_autodiff(volume_size=32, resolution=64):
    """Per-seed packed-PRB window gradients against jax.grad of the
    REINFORCE surrogate (tests/test_prb_packed.py's window pin), and the
    PRB's own run-to-run spread on this backend."""
    import jax
    import jax.numpy as jnp

    from vpt_tpu import optim
    from vpt_tpu.kernels.spectral_backward import prb_loss_and_grads
    from vpt_tpu.models import mcm_spectral as M
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import (
        LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig,
    )

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.7
    table[..., 1] = 0.1 + 0.8 * dens
    table[..., 2] = 0.5  # g density-constant: see the test's docstring
    vol = Volume.sphere_in_cube(volume_size)
    kw = dict(resolution=resolution, streams=2)
    args = (vol, MaterialTF(table), LightConfig(direction=(0.6, 0.3, 0.2)),
            SpectrumConfig(), MCMSpectralConfig(extinction=6.0, bounces=4,
                                                steps=8))
    raw = M.MCMSpectralRenderer(*args, pack_tables=False, **kw)
    packed = M.MCMSpectralRenderer(*args, pack_tables=True, **kw)
    cam = Camera()
    seeds = jnp.asarray([8, 5100, 77, 90017], jnp.uint32)
    target = jnp.full((resolution, resolution, 3), 0.25)
    params = {"density": jnp.asarray(vol.density)}

    _, g_a = jax.value_and_grad(optim.spectral_render_loss)(
        params, raw.reset(cam, 7), raw.ctx(cam, 7), seeds, target, 8, 12,
        False)

    def prb():
        _, _, _, g = prb_loss_and_grads(
            packed.reset(cam, 7), packed.ctx(cam, 7), seeds, target, 8, 12,
            wrt=frozenset({"density"}), scatter_stride=1)
        return np.asarray(g["density"])

    g_p, g_p2 = prb(), prb()
    a = np.asarray(g_a["density"])
    err = _grad_err(g_p, a)
    return dict(prb_vs_autodiff_ok=bool(err <= GRAD_TOL and np.abs(a).sum()
                                        > 0),
                prb_vs_autodiff_err=err, grad_tol=GRAD_TOL,
                prb_rerun_err=_grad_err(g_p2, g_p))


def phase_fit(volume_size=128, resolution=256, iterations=4):
    from vpt_tpu.models import mcm_spectral as M
    from vpt_tpu.optim import fit_spectral
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import (
        LightConfig, MCMSpectralConfig, SpectrumConfig,
    )

    vol = Volume.sphere_in_cube(volume_size)
    r = M.MCMSpectralRenderer(
        vol, _material(), LightConfig(direction=(1.0, 0.2, 0.5)),
        SpectrumConfig(), MCMSpectralConfig(extinction=40.0, bounces=8,
                                            steps=8),
        resolution=resolution)
    cam = Camera()
    state = r.reset(cam, 99)
    _, target = r.render_many(state, cam, _seeds(100, 16))
    target = np.asarray(target)
    init = np.full(vol.density.shape, 0.5, np.float32)

    clock = _IterationClock()
    params, losses = fit_spectral(
        target, r, cam, {"density": init}, dispatches_per_step=4,
        iterations=iterations, learning_rate=0.02, seed=3, progress=clock)
    ok = bool(np.isfinite(losses).all() and len(losses) == iterations
              and np.isfinite(np.asarray(params["density"])).all())
    return dict(ok=ok, losses=[float(x) for x in losses], **clock.times())


def phase_big_volume(volume_size=512, resolution=1024, dispatches=4):
    from vpt_tpu.scene.volume import Volume

    t0 = time.perf_counter()
    sess = _spectral_session(Volume.sphere_in_cube(volume_size), resolution)
    setup_s = time.perf_counter() - t0
    table = sess.renderer._static_ctx["density"].table
    t0 = time.perf_counter()
    sess.run(dispatches)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess.run(dispatches)
    steady_s = time.perf_counter() - t0
    img = sess.hdr_image()
    return dict(ok=bool(np.isfinite(img).all() and img.mean() > 0),
                table_bytes=int(table.nbytes), table_dtype=str(table.dtype),
                host_setup_s=setup_s, compile_s=compile_s, steady_s=steady_s)


def phase_renderers(volume_size=128, resolution=512):
    from vpt_tpu.models import RENDERERS, make_renderer
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import (
        LightConfig, MCMSpectralConfig, SpectrumConfig,
    )

    vol = Volume.sphere_in_cube(volume_size)
    cam = Camera()
    out = dict(ok=True)
    for key in sorted(RENDERERS):
        if key == "mcm-spectral":
            r = make_renderer(key, vol, _material(),
                              LightConfig(direction=(1.0, 0.2, 0.5)),
                              SpectrumConfig(),
                              MCMSpectralConfig(extinction=40.0, steps=8),
                              resolution=resolution)
        else:
            r = make_renderer(key, vol, resolution=resolution)
        state = r.reset(cam, 0)
        (state, img), compile_s = timed(lambda: r.render(state, cam, 1))
        (_, img), steady_s = timed(lambda: r.render(state, cam, 2))
        img = np.asarray(img)
        ok = bool(np.isfinite(img).all()
                  and img.shape[:2] == (resolution, resolution))
        out["ok"] &= ok
        out[key] = dict(ok=ok, compile_s=compile_s, steady_s=steady_s)
    return out


# -- multi-card phases -----------------------------------------------------

def phase_mesh_render(n, volume_size=128, resolution=512, dispatches=8):
    """Rays-sharded session on n cards vs the same session on one card:
    seeds are functions of global pixel coordinates, so the images must
    be bit-identical."""
    from vpt_tpu.parallel.mesh import ray_mesh
    from vpt_tpu.scene.volume import Volume

    vol = Volume.sphere_in_cube(volume_size)
    one = _spectral_session(vol, resolution)
    one.run(dispatches)
    ref = one.hdr_image()
    many = _spectral_session(vol, resolution, mesh=ray_mesh(n))
    t0 = time.perf_counter()
    many.run(dispatches)
    compile_s = time.perf_counter() - t0
    got = many.hdr_image()
    many.reset()
    t0 = time.perf_counter()
    many.run(dispatches)
    steady_s = time.perf_counter() - t0
    same = float(np.all(got == ref, axis=-1).mean())
    return dict(ok=bool(same == 1.0 and np.isfinite(got).all()),
                bit_identical_pixels=same, rel_l1=_rel_l1(got, ref),
                compile_s=compile_s, steady_s=steady_s)


def _slab_setup(n, volume_size, resolution):
    import jax

    from vpt_tpu.models import mcm_spectral as M
    from vpt_tpu.ops import interp
    from vpt_tpu.parallel import slab
    from vpt_tpu.parallel.mesh import ray_mesh, replicated
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import (
        LightConfig, MCMSpectralConfig, SpectrumConfig,
    )

    vol = Volume.sphere_in_cube(volume_size)
    r = M.MCMSpectralRenderer(
        vol, _material(), LightConfig(direction=(1.0, 0.2, 0.5)),
        SpectrumConfig(), MCMSpectralConfig(extinction=40.0, steps=8),
        resolution=resolution)
    mesh = ray_mesh(n)
    cam = Camera()
    padded = slab.pad_packed_for_slabs(
        interp.pack_volume_corners(vol.density), n)

    def slab_ctx(seed):
        ctx = r.ctx(cam, seed)
        return ctx._replace(
            **{f: jax.device_put(getattr(ctx, f), replicated(mesh))
               for f in ("inv_mvp", "seed_bits", "extinction", "blur",
                         "max_bounces", "light_direction", "material_tf",
                         "light_spectrum", "boundaries", "bin_xyz")},
            density=slab.shard_packed_volume(padded, mesh))

    return vol, r, cam, mesh, slab_ctx


def phase_slab_render(n, volume_size=128, resolution=512):
    from vpt_tpu.models import mcm_spectral as M
    from vpt_tpu.parallel import slab
    from vpt_tpu.parallel.mesh import shard_spectral_state

    vol, r, cam, mesh, slab_ctx = _slab_setup(n, volume_size, resolution)
    _, ref = M.render(r.reset(cam, 5), r.ctx(cam, 5), steps=8, n_bins=12)
    ref = np.asarray(ref)

    def call():
        return slab.render_slab(
            shard_spectral_state(r.reset(cam, 5), mesh), slab_ctx(5), mesh,
            volume_dims=vol.density.shape, steps=8, n_bins=12)

    _, compile_s = timed(call)
    (_, got), steady_s = timed(call)
    got = np.asarray(got)
    same = float(np.all(got == ref, axis=-1).mean())
    return dict(ok=bool(same == 1.0), bit_identical_pixels=same,
                compile_s=compile_s, steady_s=steady_s)


def phase_slab_grads(n, volume_size=128, resolution=512):
    import jax.numpy as jnp

    from vpt_tpu.kernels.spectral_backward import prb_render_and_grads
    from vpt_tpu.parallel import slab
    from vpt_tpu.parallel.mesh import shard_spectral_state

    vol, r, cam, mesh, slab_ctx = _slab_setup(n, volume_size, resolution)
    rng = np.random.default_rng(3)
    g_image = jnp.asarray(rng.standard_normal((resolution, resolution, 3)),
                          jnp.float32)
    _, ref_img, ref = prb_render_and_grads(
        r.reset(cam, 5), r.ctx(cam, 5), g_image, steps=8, n_bins=12,
        wrt=frozenset({"density"}))

    def call():
        return slab.prb_grads_slab(
            shard_spectral_state(r.reset(cam, 5), mesh), slab_ctx(5), mesh,
            volume_dims=vol.density.shape, g_image=g_image, steps=8,
            n_bins=12)

    _, compile_s = timed(call)
    (_, img, got), steady_s = timed(call)
    err = _grad_err(got["density"], ref["density"])
    same = bool((np.asarray(img) == np.asarray(ref_img)).all())
    return dict(ok=bool(err <= GRAD_TOL and same), grad_err=err,
                grad_tol=GRAD_TOL, image_bit_identical=same,
                compile_s=compile_s, steady_s=steady_s)


def phase_slab_fit(n, volume_size=512, resolution=512):
    from vpt_tpu.models import mcm_spectral as M
    from vpt_tpu.parallel import slab
    from vpt_tpu.parallel.mesh import ray_mesh
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import (
        LightConfig, MCMSpectralConfig, SpectrumConfig,
    )

    mesh = ray_mesh(n)
    vol = Volume.sphere_in_cube(volume_size)
    r = M.MCMSpectralRenderer(
        vol, _material(), LightConfig(direction=(1.0, 0.2, 0.5)),
        SpectrumConfig(), MCMSpectralConfig(extinction=40.0, steps=8),
        resolution=resolution, pack_tables={"material_tf", "light_spectrum"},
        mesh=mesh)
    init = np.full(vol.density.shape, 0.5, np.float32)
    target = np.zeros((resolution, resolution, 3), np.float32)
    clock = _IterationClock()
    params, losses = slab.fit_spectral_slab(
        target, r, Camera(), init, mesh, dispatches_per_step=2,
        iterations=2, learning_rate=1e-2, progress=clock)
    d = np.asarray(params["density"])
    return dict(ok=bool(np.isfinite(losses).all() and np.isfinite(d).all()
                        and d.shape == vol.density.shape),
                losses=[float(x) for x in losses], **clock.times())


# -- entry point -----------------------------------------------------------

def _peak_bytes(devices):
    return max(d.memory_stats()["peak_bytes_in_use"] for d in devices)


def run_phase(name, fn, devices, card):
    out = fn()
    out["peak_bytes_in_use"] = _peak_bytes(devices)
    print(f"{name}: {json.dumps(out)} [{card}]", flush=True)
    if not out["ok"]:
        raise SystemExit(f"phase {name} failed")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4 runs only the multi-card paths on 4 cards")
    args = ap.parse_args(argv)

    # the CPU reference of phase 3 runs in this process beside the card
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    from vpt_tpu.utils import runtime

    cache = runtime.init_compile_cache()
    devices = runtime.require_gpu()
    card = runtime.card_label()
    print(f"device: {devices[0].device_kind} x{len(devices)}; card "
          f"(name, power limit): {card}; compile cache: {cache}", flush=True)

    if args.devices > 1:
        if len(devices) < args.devices:
            raise SystemExit(f"--devices {args.devices} needs that many "
                             f"cards; JAX sees {len(devices)}")
        devices = devices[:args.devices]
        n = args.devices
        phases = [("mesh_render", lambda: phase_mesh_render(n)),
                  ("slab_render", lambda: phase_slab_render(n)),
                  ("slab_grads", lambda: phase_slab_grads(n)),
                  ("slab_fit", lambda: phase_slab_fit(n))]
    else:
        devices = devices[:1]
        phases = [("u8_exact", phase_u8_exact),
                  ("forward", phase_forward),
                  ("fwdbwd", phase_fwdbwd),
                  ("fit", phase_fit),
                  ("big_volume", phase_big_volume),
                  ("renderers", phase_renderers)]
    for name, fn in phases:
        run_phase(name, fn, devices, card)
    print(f"card: {card}")
    print(json.dumps({"ok": True,
                      "device": runtime.device_record(devices)}))


if __name__ == "__main__":
    sys.exit(main())
