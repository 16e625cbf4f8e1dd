"""Run the BASELINE.json capability configs on one NVIDIA GPU and print
one JSON line per config (with the device and the card's name and power
limit). Exits non-zero if any config raised.

Configs (BASELINE.md "capability configs"):
  1. 64^3 / 256^2 single-wavelength ray-march vs NumPy oracle
     -> covered by tests/test_config1_eam_oracle.py.
  2. 128^3 single-scatter MCM (MCS), 512^2 @ 16 spp
  3. 256^3 spectral MCM, 512^2 @ 64 spp + radiative-backprop density grads
  4. inverse rendering on a device mesh
     -> covered by tests/test_spectral_inverse.py / test_inverse.py on the
        virtual CPU mesh.
  5. 512^3 volume, 1024^2 @ 256 spp spectral MCM (single-card slice)

Run: python tools/capability_configs.py [--skip 5]
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def _samples(state):
    """Completed samples so far (a host fetch, so it also waits)."""
    import jax.numpy as jnp

    return int(jnp.sum(state.samples))


def config2():
    """BASELINE config 2 wording: "128^3 single-scatter MCM with Woodcock
    tracking + HG phase, 512^2 @ 16spp" — that is the RGB MCM megakernel
    (models/mcm.py: Woodcock free flights, HG scattering) capped at
    bounces=1, i.e. single scattering. MCS (the reference's dedicated
    single-scatter GLSL renderer, fixed per-frame scatter direction, no HG)
    is measured alongside as the reference-exact alternative."""
    import jax.numpy as jnp

    from vpt_tpu.models import mcm as MM
    from vpt_tpu.models.mcs import MCSRenderer
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import MCMConfig

    cam = Camera()
    vol = Volume.sphere_in_cube(128)
    spp = 16

    # -- headline: RGB MCM, bounces=1 (Woodcock + HG, per BASELINE) --------
    r = MM.MCMRenderer(
        vol, config=MCMConfig(extinction=50.0, anisotropy=0.5, bounces=1,
                              steps=8),
        resolution=512,
    )
    state = r.reset(cam, 0)
    batch = 16
    seeds = lambda lo: [(lo + k + 1) * 2654435761 % 2 ** 32 for k in range(batch)]
    state, img = r.render_many(state, cam, seeds(0))  # compile + warm
    s0 = _samples(state)
    t0 = time.perf_counter()
    rounds = 4
    for rr in range(rounds):
        state, img = r.render_many(state, cam, seeds((rr + 1) * batch))
    paths = _samples(state) - s0
    dt = time.perf_counter() - t0
    mdn = np.asarray(img)
    spp_measured = paths / (512 * 512)
    out = dict(
        config=2,
        desc="128^3 single-scatter MCM (Woodcock+HG, bounces=1) 512^2 @ 16spp",
        seconds=round(dt, 3),
        paths=int(paths), spp_measured=round(spp_measured, 1),
        mpaths_per_s=round(paths / dt / 1e6, 2),
        est_seconds_to_target_spp=round(spp * 512 * 512 / (paths / dt) , 2),
        finite=bool(np.isfinite(mdn).all()), mean=float(mdn.mean()),
    )

    # -- aux: MCS (reference-exact single-scatter algorithm) ---------------
    # Three tiers (ARCHITECTURE.md "MCS"):
    #   mcs            — reference-exact frame loops (every frame gated on
    #                    the slowest lane's collision chain: per-lane mean
    #                    12.5 trips vs max 57 measured)
    #   mcs_majorant   — same loops with super-voxel majorants (halves the
    #                    trips; the frame gate still dominates)
    #   mcs_persistent — the persistent-lane megakernel
    #                    (streams=4 + majorants): zero straggler wait,
    #                    statistically identical converged image
    # All tiers use the FRUSTUM-FILLING camera (z=1.2, same rationale as
    # config_sparse): at the default z=2 pose ~2/3 of rays miss the cube
    # and persistent miss lanes complete cheap env deposits every few
    # steps, inflating Mrays/s vs the frame tiers.
    mcs_cam = Camera(translation=np.array([0.0, 0.0, 1.2]))
    import jax

    for label, maj in (("mcs", None), ("mcs_majorant", 8)):
        r2 = MCSRenderer(vol, extinction=50.0, resolution=512,
                         majorant_blocks=maj)
        state = r2.reset(mcs_cam, 0)
        state, img = r2.render_many(state, mcs_cam, [1])  # compile
        jax.block_until_ready(img)
        t0 = time.perf_counter()
        state, img = r2.render_many(
            state, mcs_cam,
            [(f + 2) * 2654435761 % 2**32 for f in range(spp)])
        jax.block_until_ready(img)
        dt = time.perf_counter() - t0
        mdn = np.asarray(img)
        out.update({
            f"{label}_seconds": round(dt, 3),
            f"{label}_mrays_per_s": round(spp * 512 * 512 / dt / 1e6, 2),
            f"{label}_finite": bool(np.isfinite(mdn).all()),
            f"{label}_mean": float(mdn.mean()),
        })

    # persistent tiers, measured by persistent_accounting below; field
    # names state the majorant mode and stream count
    out["mcs_camera"] = "frustum-filling z=1.2 (all mcs_* tiers)"
    for label, maj in (("mcs_persistent_exact_streams4", None),
                       ("mcs_persistent_majorant8_streams4", 8)):
        acc = persistent_accounting(512, 50.0, maj, steps=8, streams=4)
        out.update({f"{label}_{k}": v for k, v in acc.items()})
    return out


def persistent_accounting(res, extinction, maj, steps=8, streams=4,
                          dispatches=16, seed=1):
    """Lane-step accounting for MCS's persistent-lane path: every lane runs
    every fori_loop step, so total lane-steps are exact (dispatches *
    steps * streams * res^2), and each lane-step issues one fused
    volume+TF gather (+1 majorant-cell gather in majorant mode). Measured
    with the frustum-filling camera (z=1.2) so Mrays/s counts transport,
    not miss-lane churn."""
    import jax

    from vpt_tpu.models.mcs import MCSRenderer
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume

    r = MCSRenderer(Volume.sphere_in_cube(128), extinction=extinction,
                    resolution=res, majorant_blocks=maj,
                    persistent=True, steps=steps, streams=streams)
    cam = Camera(translation=np.array([0.0, 0.0, 1.2]))
    state = r.reset(cam, 0)
    warm = [(k + 1) * 2654435761 % 2**32 for k in range(dispatches)]
    state, img = r.render_many(state, cam, warm)
    s0 = _samples(state)
    t0 = time.perf_counter()
    state, img = r.render_many(
        state, cam,
        [(seed + dispatches + k) * 2654435761 % 2**32
         for k in range(dispatches)])
    jax.block_until_ready(img)
    dt = time.perf_counter() - t0
    deposits = _samples(state) - s0
    lane_steps = dispatches * steps * streams * res * res
    return dict(
        mrays_per_s=round(deposits / dt / 1e6, 2),
        lane_steps_per_s_M=round(lane_steps / dt / 1e6, 1),
        steps_per_deposit=round(lane_steps / max(deposits, 1), 2),
        gathers_per_step=1 + (1 if maj else 0),
    )


def _spectral(volume_size, resolution, spp, steps=8, streams=4, grads=False,
              pack_volume=True):
    # pack_volume: True = full 8x corner table; "xy" = 4x half packing
    # (2 gathers/step — the big-volume mode); False = raw grid (8 gathers)
    import jax
    import jax.numpy as jnp

    from vpt_tpu.models import mcm_spectral as M
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import (
        LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig,
    )

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    renderer = M.MCMSpectralRenderer(
        Volume.sphere_in_cube(volume_size), MaterialTF(table),
        LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
        MCMSpectralConfig(extinction=40.0, bounces=8, steps=steps),
        resolution=resolution, streams=streams,
        pack_tables=(
            {"material_tf", "light_spectrum"}
            | ({"density_xy"} if pack_volume == "xy" else set())
            if pack_volume is not True
            else True
        ),
    )
    cam = Camera()
    ctx = renderer.ctx(cam, 1)
    state = renderer.reset(cam, 1)

    # a dispatch yields ~streams*steps samples/pixel upper bound; measure by
    # actual samples counter
    target_paths = spp * resolution * resolution
    out = {}
    if grads:
        # the canonical config-3 gradient path: hand-derived packed-adjoint
        # backward, density-only, scan-batched (prb_render_and_grads_many).
        # Measured at the exact estimator (stride 1) AND the stride-4/8
        # thinned estimators (unbiased, 4x/8x fewer scatter indices) — the
        # split shows what the scatters into the 256^3 (544 MB) adjoint
        # cost.
        from vpt_tpu.kernels.spectral_backward import prb_render_and_grads_many

        g_img = jnp.ones((resolution, resolution, 3), jnp.float32)
        wrt = frozenset({"density"})
        n = max(4, spp // (steps * streams))
        for label, stride in (("grad_stride4", 4), ("grad_stride8", 8),
                              ("grad_stride1", 1)):
            def window(st, lo):
                # warm and timed calls use the SAME window size K=n — a
                # different K is a different jitted program, whose compile
                # would land inside the timed region
                seeds = jnp.asarray(
                    [(lo + k) * 2654435761 % 2**32 for k in range(n)],
                    jnp.uint32)
                return prb_render_and_grads_many(
                    st, ctx, seeds, g_img, steps, 12, wrt=wrt,
                    scatter_stride=stride)
            st = renderer.reset(cam, 1)
            st, img, g = window(st, 2)
            jax.block_until_ready(g)
            s0 = _samples(st)
            t0 = time.perf_counter()
            st, img, g = window(st, n + 2)
            jax.block_until_ready(g)
            dt = time.perf_counter() - t0
            paths = _samples(st) - s0
            out.update({
                f"{label}_dispatches": n,
                f"{label}_seconds": round(dt, 3),
                f"{label}_mpaths_per_s": round(paths / dt / 1e6, 2),
                f"{label}_finite":
                    bool(np.isfinite(np.asarray(g["density"])).all()),
                f"{label}_norm": float(jnp.linalg.norm(g["density"])),
            })
        out["grad_dispatches"] = n
        # the canonical config-3 grad rate = the production stride-4
        # estimator; the per-stride fields above carry each measurement
        out["grad_mpaths_per_s"] = out["grad_stride4_mpaths_per_s"]
        # the measured wall split at this size: cost(k) =
        # base + scatter/k ms per window, solved from the stride pair
        t1 = out["grad_stride1_seconds"]
        t4 = out["grad_stride4_seconds"]
        scatter = (t1 - t4) / 0.75
        out["grad_wall_split"] = dict(
            window_ms_base=round((t1 - scatter) * 1000, 1),
            window_ms_scatter_stride1=round(scatter * 1000, 1))
        return out

    batch = 16
    seeds = lambda lo: jnp.asarray(
        [(lo + k) * 2654435761 % 2 ** 32 for k in range(batch)], jnp.uint32)
    state, img = M.render_many(state, ctx, seeds(0), steps=steps, n_bins=12)
    s_before = _samples(state)
    t0 = time.perf_counter()
    rounds = 4
    for r in range(rounds):
        state, img = M.render_many(state, ctx, seeds((r + 1) * batch),
                                   steps=steps, n_bins=12)
    done = int(_samples(state))
    dt = time.perf_counter() - t0
    paths = done - int(s_before)
    # spp = mean completed samples per pixel-stream (the accumulator's n)
    spp_measured = paths / (resolution * resolution * streams)
    mpaths = paths / dt / 1e6
    out.update(
        seconds=round(dt, 3), paths=paths,
        spp_measured=round(spp_measured, 1),
        mpaths_per_s=round(mpaths, 2),
        est_seconds_to_target_spp=round(
            spp * resolution * resolution * streams / (mpaths * 1e6), 1),
        image_finite=bool(np.isfinite(np.asarray(img)).all()),
    )
    return out


def config3():
    fwd = _spectral(256, 512, spp=64)
    bwd = _spectral(256, 512, spp=64, grads=True, streams=4)
    return dict(config=3, desc="256^3 spectral MCM 512^2 @ 64spp + density grads",
                **fwd, **bwd)


def config5():
    # two big-volume representations: the xy half packing (u8 540 MB,
    # 2 gathers/step) vs the full 8-wide corner table (u8 1.08 GB,
    # 1 gather/step). Both bit-exact for the u8-quantized source volume.
    fwd = _spectral(512, 1024, spp=256, streams=1, pack_volume="xy")
    out = dict(config=5,
               desc="512^3 spectral MCM 1024^2 @ 256spp (single-card slice)",
               **fwd)
    full = _spectral(512, 1024, spp=256, streams=1, pack_volume=True)
    out.update({f"full_u8_{k}": v for k, v in full.items()
                if k in ("seconds", "mpaths_per_s", "spp_measured",
                         "image_finite")})
    return out


def config_sparse():
    """The majorant mode's capability scene: 512^3 at ~0.2%
    occupancy — a few small dense spheres in empty space. In this regime
    paths delta-track their way across near-empty space at the global rate
    (steps-per-path ~ extinction * path length), so the per-cell
    (majorant, validity-range) table (ops/majorant) wins big.

    The camera FILLS the frustum with the cube (translation z=1.2): with
    the default z=2 pose ~2/3 of pixels never intersect the volume, and
    those miss lanes complete a trivial one-step "path" every step
    (reference-faithful: oob -> deposit light -> respawn), so Mpaths/s
    measures miss-lane churn, not transport — the majorant mode measured
    as a LOSS on the sparse scene until the frustum was filled (0.72x ->
    5x, ARCHITECTURE.md "what Mpaths/s counts")."""
    import jax.numpy as jnp

    from vpt_tpu.models import mcm_spectral as M
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import (
        LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig,
    )

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    vol = Volume.sparse_spheres(512)
    occupancy = float((np.asarray(vol.density) > 0).mean())

    out = dict(config="sparse",
               desc="512^3 sparse scene (~{:.2%} occupancy) 512^2 "
                    "frustum-filling camera, exact vs super-voxel "
                    "majorant".format(occupancy))

    def run(maj, seed_base, timed=True):
        r = M.MCMSpectralRenderer(
            vol, MaterialTF(table), LightConfig(direction=(1.0, 0.2, 0.5)),
            SpectrumConfig(),
            MCMSpectralConfig(extinction=40.0, bounces=8, steps=8),
            resolution=512, streams=4,
            pack_tables={"density_xy", "material_tf", "light_spectrum"},
            majorant_blocks=maj,
        )
        cam = Camera(translation=np.array([0.0, 0.0, 1.2]))
        ctx = r.ctx(cam, 1)
        state = r.reset(cam, 1)
        batch = 16
        seeds = lambda lo: jnp.asarray(
            [(seed_base + lo + k) * 2654435761 % 2**32 for k in range(batch)],
            jnp.uint32)
        state, img = M.render_many(state, ctx, seeds(0), steps=8, n_bins=12)
        s0 = _samples(state)
        t0 = time.perf_counter()
        for rr in range(3):
            state, img = M.render_many(state, ctx, seeds((rr + 1) * batch),
                                       steps=8, n_bins=12)
        paths = _samples(state) - s0
        dt = time.perf_counter() - t0
        return np.asarray(img), paths / dt / 1e6

    img_exact, mp_exact = run(None, 0)
    img_major, mp_major = run(16, 0)
    # per-pixel parity: relative L1 of the majorant
    # image vs the exact image at MATCHED dispatch count, judged against
    # the exact path's own seed-to-seed noise floor at the same count —
    # a scalar mean-of-means would pass with badly wrong spatial structure
    img_exact_b, _ = run(None, 10_000)
    norm = max(float(np.abs(img_exact).mean()), 1e-9)
    rel_l1 = float(np.abs(img_exact - img_major).mean()) / norm
    floor = float(np.abs(img_exact - img_exact_b).mean()) / norm
    out["exact_mpaths_per_s"] = round(mp_exact, 2)
    out["majorant_mpaths_per_s"] = round(mp_major, 2)
    out["exact_finite"] = bool(np.isfinite(img_exact).all())
    out["majorant_finite"] = bool(np.isfinite(img_major).all())
    out["speedup"] = round(mp_major / max(mp_exact, 1e-9), 2)
    out["pixel_rel_l1_vs_exact"] = round(rel_l1, 4)
    out["pixel_rel_l1_noise_floor"] = round(floor, 4)
    out["pixel_parity_ok"] = bool(rel_l1 < 2.0 * floor + 1e-3)
    return out


def scaling_virtual8():
    """Run the scaling harness (weak-scaling sweep + collective
    microbenchmark, parallel/scaling.py) on the virtual 8-device CPU mesh
    in a CPU-only child process (the parent holds the card) — the same
    harness a multi-card sweep uses; these numbers validate the harness
    and the sharded program, NOT interconnect bandwidth (the 8 'devices'
    share one CPU host)."""
    import subprocess

    code = (
        "import json;\n"
        "from vpt_tpu.parallel.scaling import scaling_sweep, collective_microbench;\n"
        "from vpt_tpu.parallel.mesh import ray_mesh;\n"
        "rows = scaling_sweep(device_counts=[1,2,4,8], rows_per_device=64,"
        " width=128, volume_size=32, steps=8, dispatches=8, verbose=False);\n"
        "mb = collective_microbench(ray_mesh(8), size_mb=32.0);\n"
        "print(json.dumps(dict(sweep=rows, microbench=mb)))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=900,
                         check=True)
    data = json.loads(out.stdout.strip().splitlines()[-1])
    return dict(config="scaling-virtual8", desc="scaling harness on the "
                "virtual 8-device CPU mesh (harness validation, not "
                "interconnect)",
                **data)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip", nargs="*", type=int, default=[])
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from vpt_tpu.utils import runtime

    runtime.init_compile_cache()
    where = {"device": runtime.device_record(runtime.require_gpu()),
             "card": runtime.card_label()}
    failed = []
    for n, fn in ((2, config2), (3, config3), (5, config5),
                  ("sparse", config_sparse), ("scaling", scaling_virtual8)):
        if n in args.skip:
            continue
        print(f"running config {n}...", file=sys.stderr)
        try:
            row = fn()
        except Exception as e:  # report every config, then fail the run
            row = dict(config=n, error=f"{type(e).__name__}: {e}"[:300])
            failed.append(n)
        print(json.dumps(dict(row, **where)), flush=True)
    if failed:
        raise SystemExit(f"configs failed: {failed}")


if __name__ == "__main__":
    main()
