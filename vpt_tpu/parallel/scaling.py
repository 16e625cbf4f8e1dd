"""Multi-host / multi-chip scaling harness (BASELINE config 5).

Three pieces:
  - ``initialize_distributed()``: the jax.distributed bootstrap for
    multi-host pods (no-op when the coordinator env isn't set).
  - ``collective_microbench(mesh)``: achieved psum / all_gather bandwidth
    over the mesh's interconnect — reported next to scaling numbers
    (SURVEY.md §5 distributed-communication entry).
  - ``scaling_sweep(...)``: rays/s for the spectral render dispatch on
    1..N-device meshes, with efficiency vs the single-device baseline.
    Runs identically on real chips and on the virtual CPU mesh used in CI.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np


def initialize_distributed():
    """Initialize jax.distributed from standard env vars; safe to call when
    single-process (returns False).

    Reads COORDINATOR_ADDRESS / JAX_COORDINATOR_ADDRESS, and — when the
    deployment is not auto-detectable (e.g. plain multi-process over
    loopback, tools/multiprocess_dryrun.py) — JAX_NUM_PROCESSES and
    JAX_PROCESS_ID for the explicit bootstrap."""
    import jax

    addr = (os.environ.get("COORDINATOR_ADDRESS")
            or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if not addr:
        return False
    kw = dict(coordinator_address=addr)
    if os.environ.get("JAX_NUM_PROCESSES"):
        kw["num_processes"] = int(os.environ["JAX_NUM_PROCESSES"])
        kw["process_id"] = int(os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(**kw)
    return True


def collective_microbench(mesh, size_mb: float = 64.0, reps: int = 10) -> dict:
    """Measure psum and all_gather throughput over ``mesh`` ("rays" axis)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = mesh.devices.size
    elems = int(size_mb * 1e6 / 4)
    elems -= elems % max(n, 1)
    x = jnp.ones((elems,), jnp.float32)
    xs = jax.device_put(x, NamedSharding(mesh, P("rays")))

    @jax.jit
    def do_psum(v):
        return jax.shard_map(
            lambda s: jax.lax.psum(s, "rays"),
            mesh=mesh, in_specs=P("rays"), out_specs=P("rays"),
            check_vma=False,
        )(v)

    @jax.jit
    def do_allgather(v):
        return jax.shard_map(
            lambda s: jax.lax.all_gather(s, "rays", tiled=True),
            mesh=mesh, in_specs=P("rays"), out_specs=P(None),
            check_vma=False,
        )(v)

    out = {}
    for name, fn in [("psum", do_psum), ("all_gather", do_allgather)]:
        r = fn(xs)
        jax.block_until_ready(r)
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn(xs)
        jax.block_until_ready(r)
        dt = (time.perf_counter() - t0) / reps
        # bytes moved per device (ring lower bound): 2(n-1)/n * size
        moved = 2 * (n - 1) / max(n, 1) * elems * 4
        out[f"{name}_s"] = dt
        out[f"{name}_GBps"] = moved / dt / 1e9 if dt > 0 else float("inf")
    out["devices"] = n
    out["size_mb"] = elems * 4 / 1e6
    return out


def _rect_grids(H: int, W: int):
    import jax
    import jax.numpy as jnp

    iy = jax.lax.broadcasted_iota(jnp.uint32, (H, W), 0)
    ix = jax.lax.broadcasted_iota(jnp.uint32, (H, W), 1)
    sx = ((ix.astype(jnp.float32) + 0.5) / W - 0.5) * 2.0
    sy = ((iy.astype(jnp.float32) + 0.5) / H - 0.5) * -2.0
    return ix, iy, sx, sy


def _rect_reset(ctx, H: int, W: int, n_bins: int):
    """Fresh photons over an (H, W) RECTANGULAR framebuffer.

    The sweep's framebuffer is (rows_per_device * n, width) with the H axis
    sharded over "rays" — rectangular so per-device lanes stay CONSTANT
    across the sweep (a square framebuffer cannot hold per-device pixels
    fixed while scaling devices). NDC maps y over the full span (sy from
    1/H), so every sweep size renders the same scene at different vertical
    ray density and each lane's workload is distributionally identical."""
    import functools

    import jax
    import jax.numpy as jnp

    from vpt_tpu.models import mcm_spectral as M
    from vpt_tpu.ops import sampling

    @functools.partial(jax.jit, static_argnames=("H", "W", "n_bins"))
    def run(ctx, H, W, n_bins):
        ix, iy, sx, sy = _rect_grids(H, W)
        rng0 = sampling.seed_state(ix, iy, ctx.seed_bits)
        mask = jnp.ones((H, W), bool)
        rng0, new = M._respawn(rng0, mask, sx, sy, ctx, n_bins)
        return M.SpectralState(
            px=new["px"], py=new["py"], pz=new["pz"],
            dx=new["dx"], dy=new["dy"], dz=new["dz"],
            bounces=jnp.zeros((H, W), jnp.int32),
            samples=jnp.zeros((H, W), jnp.int32),
            bin=new["bin"], wavelength=new["wavelength"],
            radiance=jnp.ones((n_bins, H, W), jnp.float32),
            transmittance=jnp.ones((n_bins, H, W), jnp.float32),
        )

    return run(ctx, H, W, n_bins)


def _rect_render_many(state, ctx, seeds, steps: int, n_bins: int):
    """K scan-batched dispatches over the rect framebuffer (the sweep's
    timed unit; sharding propagates from the row-sharded ``state``)."""
    import functools

    import jax

    from vpt_tpu.models import mcm_spectral as M
    from vpt_tpu.ops import sampling

    @functools.partial(jax.jit, static_argnames=("steps", "n_bins"),
                       donate_argnames=("state",))
    def run(state, ctx, seeds, steps, n_bins):
        H, W = state.px.shape
        ix, iy, sx, sy = _rect_grids(H, W)

        def dispatch(p, seed_bits):
            rng = sampling.seed_state(ix, iy, seed_bits)

            def body(_, carry):
                q, r = carry
                q, r, _ = M._render_body(q, r, None, sx, sy, ctx, n_bins,
                                         "linear", diff=False)
                return (q, r)

            p, _ = jax.lax.fori_loop(0, steps, body, (p, rng))
            return p, None

        state, _ = jax.lax.scan(dispatch, state, seeds)
        return state, M.radiance_to_rgb(state.radiance, ctx.bin_xyz)

    return run(state, ctx, seeds, steps, n_bins)


def scaling_sweep(
    device_counts: Optional[List[int]] = None,
    rows_per_device: int = 128,
    width: int = 256,
    volume_size: int = 64,
    steps: int = 8,
    dispatches: int = 16,
    verbose: bool = True,
) -> List[dict]:
    """Weak-scaling sweep of the spectral render dispatch.

    Each mesh size renders an (H, W) = (rows_per_device * n, width)
    framebuffer with the H axis sharded over "rays" — per-device lanes are
    ``rows_per_device * width`` for EVERY device count, a provable
    constant-per-device-work weak-scaling design (the old
    square-framebuffer sweep grew per-device pixels linearly with n, which
    overstates efficiency on hardware where throughput is sub-linear in
    lane count and understates it on a shared CPU host). Efficiency is
    rays/s/device vs the single-device run at the identical per-device
    lane count.
    """
    import jax
    import jax.numpy as jnp

    from vpt_tpu.models import mcm_spectral as M
    from vpt_tpu.parallel.mesh import ray_mesh, shard_ctx
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import (
        LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig,
    )

    if device_counts is None:
        total = len(jax.devices())
        device_counts = sorted({1, 2, total} & set(range(1, total + 1))) or [1]

    renderer = M.MCMSpectralRenderer(
        Volume.sphere_in_cube(volume_size),
        MaterialTF.constant(0.8, 0.5),
        LightConfig(direction=(1.0, 0.2, 0.5)),
        SpectrumConfig(),
        MCMSpectralConfig(extinction=40.0, steps=steps),
        resolution=width,
    )
    cam = Camera()
    results = []
    base_rate = None
    for n in device_counts:
        H = rows_per_device * n
        mesh = ray_mesh(n)
        from vpt_tpu.parallel.mesh import shard_spectral_state

        ctx = shard_ctx(renderer.ctx(cam, 1), mesh)
        state = shard_spectral_state(_rect_reset(ctx, H, width, 12), mesh)
        seeds = jnp.asarray(
            [(k + 1) * 2654435761 % 2**32 for k in range(dispatches)], jnp.uint32
        )
        # warm (compile), then time one full K-dispatch program
        state, img = _rect_render_many(state, ctx, seeds, steps, 12)
        jax.block_until_ready(img)
        t0 = time.perf_counter()
        state, img = _rect_render_many(state, ctx, seeds, steps, 12)
        jax.block_until_ready(img)
        dt = time.perf_counter() - t0
        rays = H * width * dispatches
        rate = rays / dt
        rate_per_dev = rate / n
        if base_rate is None:
            base_rate = rate_per_dev
        eff = rate_per_dev / base_rate
        row = dict(devices=n, rows=H, width=width,
                   lanes_per_device=rows_per_device * width,
                   rays_per_s=rate,
                   rays_per_s_per_device=rate_per_dev, efficiency=eff,
                   seconds=dt)
        results.append(row)
        if verbose:
            print(f"devices={n:2d} fb={H}x{width} rays/s={rate:,.0f} "
                  f"eff={eff:.1%}")
    return results


if __name__ == "__main__":
    import json

    initialize_distributed()
    rows = scaling_sweep()
    import jax

    if len(jax.devices()) > 1:
        from vpt_tpu.parallel.mesh import ray_mesh

        print(json.dumps(collective_microbench(ray_mesh())))
    print(json.dumps(rows))
