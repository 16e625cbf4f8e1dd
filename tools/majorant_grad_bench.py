"""Majorant-mode INVERSE benchmark: does the sparse-scene forward win of the
majorant mode (tools/capability_configs.py config_sparse) carry into
fwd+bwd?

Measures the autodiff-surrogate gradient step (the majorant mode's gradient
path — the taped packed-PRB backward does not support the mode) on the
512^3 sparse_spheres scene at the frustum-filling camera, exact vs
super-voxel majorant, density-only gradients. The estimator's step count
per path is what the majorant mode shrinks; both the forward pass and the
REINFORCE-surrogate backward replay every step, so the win should carry
at roughly the forward's ratio (minus the surrogate's constant overhead).

Run on the GPU: python tools/majorant_grad_bench.py [--volume 512]
"""

import argparse
import json
import sys
import time

import numpy as np


def measure(maj_blocks, volume, res, steps, streams, dispatches, seed=1):
    import jax
    import jax.numpy as jnp

    from vpt_tpu import optim
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
    vol = Volume.sparse_spheres(volume)
    r = M.MCMSpectralRenderer(
        vol, MaterialTF(table), LightConfig(direction=(1.0, 0.2, 0.5)),
        SpectrumConfig(),
        MCMSpectralConfig(extinction=40.0, bounces=8, steps=steps),
        resolution=res, streams=streams,
        # raw density (the learned param is raw; autodiff packs in-graph),
        # fused TF+light for the fast material path
        pack_tables={"material_tf", "light_spectrum"},
        majorant_blocks=maj_blocks,
    )
    cam = Camera(translation=np.array([0.0, 0.0, 1.2]))
    base_ctx = r.ctx(cam, seed)
    state0 = r.reset(cam, seed)
    target = jnp.zeros((res, res, 3), jnp.float32)
    params = {"density": jnp.asarray(vol.density)}

    @jax.jit
    def loss_and_grad(params, seeds):
        return jax.value_and_grad(optim.spectral_render_loss)(
            params, state0, base_ctx, seeds, target, steps, 12,
            pack_params=False)

    def seeds_for(lo):
        return jnp.asarray(
            [(lo + k + 1) * 2654435761 % 2**32 for k in range(dispatches)],
            jnp.uint32)

    lv, g = loss_and_grad(params, seeds_for(0))  # compile + warm
    float(jnp.sum(g["density"]))
    # paths per window via a forward probe (same seeds -> same event
    # sequence; render_sequence_diff is forward-bit-identical)
    st, _ = M.render_many(r.reset(cam, seed), base_ctx, seeds_for(1),
                          steps=steps, n_bins=12)
    s0 = float(jnp.sum(st.samples))
    st, _ = M.render_many(st, base_ctx, seeds_for(2), steps=steps, n_bins=12)
    paths_per_window = float(jnp.sum(st.samples)) - s0

    reps = 3
    t0 = time.perf_counter()
    for k in range(reps):
        lv, g = loss_and_grad(params, seeds_for(k + 3))
    float(jnp.sum(g["density"]))
    dt = (time.perf_counter() - t0) / reps
    return dict(
        mpaths_per_s=round(paths_per_window / dt / 1e6, 3),
        seconds_per_window=round(dt, 3),
        grad_finite=bool(np.isfinite(np.asarray(g["density"])).all()),
        grad_norm=float(jnp.linalg.norm(g["density"])),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--volume", type=int, default=512)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--dispatches", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=16)
    args = ap.parse_args()

    out = dict(config="sparse-majorant-grads",
               desc=f"{args.volume}^3 sparse scene fwd+bwd (autodiff "
                    "surrogate, density grads), frustum camera, exact vs "
                    "super-voxel majorant")
    for label, maj in (("exact", None), ("majorant", args.blocks)):
        print(f"measuring {label}...", file=sys.stderr)
        m = measure(maj, args.volume, args.res, args.steps, args.streams,
                    args.dispatches)
        print(f"# {label}: {m}", file=sys.stderr)
        out.update({f"{label}_{k}": v for k, v in m.items()})
    out["fwdbwd_speedup"] = round(
        out["majorant_mpaths_per_s"] / max(out["exact_mpaths_per_s"], 1e-9), 2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
