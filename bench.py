"""Benchmark: spectral MCM throughput on one NVIDIA GPU.

Prints ONE JSON line. The headline metric is the BASELINE.json workload,
**fwd+bwd Mpaths/s/chip at 512^2 x 64 spp** with density gradients, on
the production estimator: the packed-adjoint window backward with
scatter_stride=4 thinning (kernels/spectral_backward.py). The exact
(stride 1) and importance-thinned estimators and forward-only throughput
ride as auxiliary fields, with lane-step rates against gather and scatter
ceilings measured in the same run at the bench's own table sizes, and the
kernel-level u8 bit-exactness check. A "path" is one completed photon
sample.

Every line names the device (platform, device_kind, count) and the card's
name and power limit. Without a GPU the bench exits non-zero: a CPU time
is not a device number.

Why stride 4 is the headline: thinning is unbiased (phase-partition
identity, tests/test_prb_packed.py::test_scatter_stride_partition_identity)
and cuts scatter indices 4x; whether that trade still pays on this card is
an open measurement (ROADMAP Speed 2 and 7).

BENCH_MODE=fwd prints only the forward-throughput line.
"""

import json
import os
import sys
import time

import numpy as np


def _scene(resolution, volume_size, steps, streams):
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
        Volume.sphere_in_cube(volume_size),
        MaterialTF(table),
        LightConfig(direction=(1.0, 0.2, 0.5)),
        SpectrumConfig(),
        MCMSpectralConfig(extinction=40.0, bounces=8, steps=steps),
        resolution=resolution,
        streams=streams,
    )
    return renderer, Camera()


def measure_forward(resolution, volume_size, steps, streams, batch, reps):
    """Forward-only Mpaths/s via render_many (scan-batched dispatches)."""
    import jax
    import jax.numpy as jnp
    from vpt_tpu.models import mcm_spectral as M

    renderer, camera = _scene(resolution, volume_size, steps, streams)
    ctx = renderer.ctx(camera, 1)

    def seeds(lo):
        return jnp.asarray(
            [(lo + k) * 2654435761 % 2**32 for k in range(batch)], jnp.uint32
        )

    state = renderer.reset(camera, seed=1)
    state, img = M.render_many(state, ctx, seeds(0), steps=steps, n_bins=12)
    jax.block_until_ready(img)
    samples_before = int(jnp.sum(state.samples))

    t0 = time.perf_counter()
    for r in range(reps):
        state, img = M.render_many(
            state, ctx, seeds((r + 1) * batch), steps=steps, n_bins=12
        )
    jax.block_until_ready(img)
    dt = time.perf_counter() - t0

    paths = int(jnp.sum(state.samples)) - samples_before
    mpaths = paths / dt / 1e6
    # lane-steps are exact: every lane executes every fori step of every
    # dispatch (the lockstep megakernel), so the rate is a closed form
    lane_steps = resolution * resolution * streams * steps * reps * batch
    print(
        f"# fwd: {reps * batch} dispatches in {dt:.3f}s; "
        f"{paths / (resolution * resolution):.1f} spp; {mpaths:.1f} Mpaths/s; "
        f"{lane_steps / dt / 1e6:.1f} M lane-steps/s",
        file=sys.stderr,
    )
    return mpaths, lane_steps / dt


def measure_fwdbwd(resolution, volume_size, steps, streams, target_spp,
                   scatter_stride=1, chunk=4, scatter_mode="stride"):
    """fwd+bwd Mpaths/s on the production shape: scan-batched packed-adjoint
    windows (prb_render_and_grads_many — image + summed density gradients
    per K-dispatch device program) until >= target_spp accumulated."""
    import jax
    import jax.numpy as jnp
    from vpt_tpu.kernels.spectral_backward import prb_render_and_grads_many

    renderer, camera = _scene(resolution, volume_size, steps, streams)
    ctx = renderer.ctx(camera, 1)
    state = renderer.reset(camera, 1)
    g_img = jnp.ones((resolution, resolution, 3), jnp.float32)
    wrt = frozenset({"density"})

    def window(state, lo):
        seeds = jnp.asarray(
            [(lo + k) * 2654435761 % 2**32 for k in range(chunk)], jnp.uint32)
        return prb_render_and_grads_many(
            state, ctx, seeds, g_img, steps, 12, wrt=wrt,
            scatter_stride=scatter_stride, scatter_mode=scatter_mode)

    state, img, g = window(state, 2)  # compile + warm
    s_before = int(jnp.sum(state.samples))

    spp_per = max(s_before / (resolution * resolution * streams), 1e-6)
    reps = max(int(np.ceil(target_spp / spp_per)), 2)

    t0 = time.perf_counter()
    for k in range(reps):
        state, img, g = window(state, (k + 1) * chunk + 2)
    jax.block_until_ready((state, img, g))
    dt = time.perf_counter() - t0
    paths = int(jnp.sum(state.samples)) - s_before
    spp = paths / (resolution * resolution * streams)
    mpaths = paths / dt / 1e6
    lane_steps = resolution * resolution * streams * steps * reps * chunk
    print(
        f"# fwd+bwd ({scatter_mode}={scatter_stride}): {reps * chunk} "
        f"dispatches in {dt:.2f}s; {spp:.1f} spp; {mpaths:.2f} Mpaths/s; "
        f"{lane_steps / dt / 1e6:.1f} M lane-steps/s",
        file=sys.stderr,
    )
    return mpaths, lane_steps / dt


def check_u8_bit_exact():
    """Kernel-level guard for the u8 packed-table exactness claim: sampling
    a u8-quantized volume through the packed-u8 path must be bit-identical
    to the raw-f32 path for every code, on this backend. A compiler that
    folds the Newton step of interp._dequantize_rows back into a
    reciprocal multiply breaks bit-parity silently; the isolated
    expression is not enough, so this runs the sample_volume path on all
    256 codes at random coordinates."""
    import jax
    import jax.numpy as jnp
    from vpt_tpu.ops import interp

    codes = np.arange(256, dtype=np.uint8).reshape(4, 8, 8)
    raw = codes.astype(np.float32) / np.float32(255.0)
    pv = interp.pack_volume_auto(raw, "full")
    assert isinstance(pv, interp.PackedVolume) and pv.table.dtype == jnp.uint8
    rng = np.random.default_rng(0)
    u, v, w = (jnp.asarray(rng.random(4096, dtype=np.float32))
               for _ in range(3))

    @jax.jit
    def sample(vol, u, v, w):
        return interp.sample_volume(vol, u, v, w, "linear")

    a = np.asarray(sample(jnp.asarray(raw), u, v, w))
    b = np.asarray(sample(pv, u, v, w))
    ok = bool((a == b).all())
    if not ok:
        bad = int((a != b).sum())
        print(f"# WARNING: packed-u8 sampling NOT bit-exact on this backend "
              f"({bad}/{a.size} samples differ) — XLA re-fused the "
              f"compensated 1/255; auto-u8 packed tables lost bit-parity",
              file=sys.stderr)
    return ok


def measure_ceilings(volume_size):
    """Speed-of-light microbenches for the two memory walls, measured on
    the current device at the bench's own table sizes:

    - gather ceiling: lane-steps/s of the forward's largest access — one
      8-wide u8 corner-row gather per lane-step;
    - scatter ceiling: lane-steps/s of the exact backward's largest access
      — one 8-wide f32 row scatter-add into the packed-volume adjoint.

    Precomputed random index streams scanned step by step, one access
    per lane per step.
    """
    import jax
    import jax.numpy as jnp
    from vpt_tpu.ops.interp import _dequantize_rows

    lanes = 1 << 20
    iters = 16
    Dp = volume_size + 1
    rows = Dp * Dp * Dp
    rng = np.random.default_rng(1)
    idx = jnp.asarray(rng.integers(0, rows, (iters, lanes), dtype=np.int32))
    table = jnp.zeros((rows, 8), jnp.uint8)
    upd = jnp.ones((lanes, 8), jnp.float32)

    @jax.jit
    def gather_run(idx, t):
        def body(acc, ix):
            r = _dequantize_rows(jnp.take(t, ix, axis=0))
            return acc + jnp.sum(r, axis=-1), None

        acc, _ = jax.lax.scan(body, jnp.zeros((lanes,), jnp.float32), idx)
        return acc

    @jax.jit
    def scatter_run(idx, upd):
        # adjoint initialized inside the program, like the real backward's
        # _packed_adj_init
        def body(a, ix):
            return a.at[ix].add(upd), None

        a, _ = jax.lax.scan(body, jnp.zeros((rows, 8), jnp.float32), idx)
        return a

    out = {}
    jax.block_until_ready(gather_run(idx, table))
    t0 = time.perf_counter()
    jax.block_until_ready(gather_run(idx, table))
    out["gather_ceiling_lane_steps_per_s"] = lanes * iters / (
        time.perf_counter() - t0)

    jax.block_until_ready(scatter_run(idx, upd))
    t0 = time.perf_counter()
    jax.block_until_ready(scatter_run(idx, upd))
    out["scatter_ceiling_lane_steps_per_s"] = lanes * iters / (
        time.perf_counter() - t0)
    return out


def main():
    from vpt_tpu.utils import runtime

    runtime.init_compile_cache()
    devices = runtime.require_gpu()
    where = {"device": runtime.device_record(devices),
             "card": runtime.card_label()}
    resolution = int(os.environ.get("BENCH_RES", "512"))
    steps = int(os.environ.get("BENCH_STEPS", "8"))
    volume_size = int(os.environ.get("BENCH_VOLUME", "128"))
    streams = int(os.environ.get("BENCH_STREAMS", "4"))

    u8_ok = check_u8_bit_exact()
    ceil = measure_ceilings(volume_size)
    g_ceil = ceil["gather_ceiling_lane_steps_per_s"]
    s_ceil = ceil["scatter_ceiling_lane_steps_per_s"]
    # exact fwd+bwd pays both walls per lane-step (one corner-row gather in
    # the taped forward + one adjoint-row scatter in the reverse); per-index
    # costs are additive, so the combined ceiling is the harmonic form
    fb_ceil = 1.0 / (1.0 / g_ceil + 1.0 / s_ceil)

    fwd, fwd_ls = measure_forward(
        resolution, volume_size, steps, streams,
        batch=int(os.environ.get("BENCH_BATCH", "64")),
        reps=int(os.environ.get("BENCH_REPS", "5")))
    if os.environ.get("BENCH_MODE") == "fwd":
        print(json.dumps({
            "metric": "spectral_mcm_fwd_throughput_512x512",
            "value": round(fwd, 3),
            "unit": "Mpaths/s/chip",
            "fwd_lane_steps_per_s": round(fwd_ls),
            "gather_ceiling_lane_steps_per_s": round(g_ceil),
            "fwd_fraction_of_gather_ceiling": round(fwd_ls / g_ceil, 3),
            "u8_dequantize_bit_exact": u8_ok,
            **where,
        }))
        return

    target_spp = int(os.environ.get("BENCH_SPP", "64"))
    exact, exact_ls = measure_fwdbwd(resolution, volume_size, steps, streams,
                                     target_spp)
    thinned, _ = measure_fwdbwd(resolution, volume_size, steps, streams,
                                target_spp, scatter_stride=4)
    importance, _ = measure_fwdbwd(resolution, volume_size, steps, streams,
                                   target_spp, scatter_stride=4,
                                   scatter_mode="importance")
    print(json.dumps({
        "metric": "spectral_mcm_fwdbwd_thinned_s4_512x512_64spp",
        "value": round(thinned, 3),
        "unit": "Mpaths/s/chip",
        "fwd_mpaths_per_s": round(fwd, 3),
        "fwdbwd_exact_stride1": round(exact, 3),
        # importance thinning at stride-4's index budget (the sparse-scene
        # estimator of fit_spectral's "auto" policy)
        "fwdbwd_importance_i4": round(importance, 3),
        # lane-step rates vs the gather/scatter ceilings measured on this
        # device at this table size
        "fwd_lane_steps_per_s": round(fwd_ls),
        "gather_ceiling_lane_steps_per_s": round(g_ceil),
        "fwd_fraction_of_gather_ceiling": round(fwd_ls / g_ceil, 3),
        "fwdbwd_exact_lane_steps_per_s": round(exact_ls),
        "scatter_ceiling_lane_steps_per_s": round(s_ceil),
        "fwdbwd_ceiling_lane_steps_per_s": round(fb_ceil),
        "fwdbwd_fraction_of_ceiling": round(exact_ls / fb_ceil, 3),
        "u8_dequantize_bit_exact": u8_ok,
        **where,
    }))


if __name__ == "__main__":
    main()
