"""Two-process jax.distributed dryrun over loopback:
exercise the REAL multi-process code path — coordinator bootstrap
(parallel/scaling.initialize_distributed), a cross-process 8-device mesh,
a sharded render through the public renderer API, and one sharded
inverse-rendering step — without any extra hardware, and assert the
render is BIT-IDENTICAL to the single-process 8-device result (the
mesh-shape determinism contract, now across process boundaries).

Topology: 2 processes x 4 virtual CPU devices each = one global 8-device
"rays" mesh. The DCN here is loopback gRPC; what this validates is the
code path (env bootstrap, global-device mesh construction, device_put of
host data onto a cross-process sharding, collectives spanning processes,
per-process addressable shards + process_allgather assembly), not
bandwidth.

Run: python tools/multiprocess_dryrun.py
Writes MULTIPROCESS.json next to the repo root when invoked from there.
"""

import json
import os
import subprocess
import sys

# script mode puts tools/ (not the repo root) at sys.path[0]; make the
# package importable for this process and every subprocess it spawns —
# APPEND to PYTHONPATH, never overwrite (plugins may ride on it)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)
os.environ["PYTHONPATH"] = (
    _REPO + os.pathsep + os.environ.get("PYTHONPATH", "")).rstrip(os.pathsep)

PORT = int(os.environ.get("VPT_MP_PORT", "12655"))
RES = 32  # rows divisible by 8


def _free_port() -> int:
    """Bind-and-release an ephemeral port for the coordinator so concurrent
    runs (or a lingering coordinator from an aborted one) cannot collide."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def scene_args():
    import numpy as np

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    return table


def render_and_step(mesh):
    """Sharded render + one spectral PRB training step on ``mesh`` through
    the PUBLIC APIs; returns (hdr_image_global, loss, grad_norm)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from vpt_tpu.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu.optim import InverseState, make_spectral_prb_step
    from vpt_tpu.parallel.mesh import replicated, row_sharding
    from vpt_tpu.scene.camera import Camera
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import (
        LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig,
    )

    renderer = MCMSpectralRenderer(
        Volume.sphere_in_cube(16), MaterialTF(scene_args()),
        LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
        MCMSpectralConfig(extinction=30.0, bounces=4, steps=4),
        resolution=RES, mesh=mesh)
    cam = Camera()
    state = renderer.reset(cam, 7)
    state, img = renderer.render_many(state, cam, [11, 12, 13])

    # one training step: replicated params, rays-sharded target, the
    # gradient all-reduce spans the two processes
    params = {"density": jax.device_put(
        jnp.asarray(Volume.sphere_in_cube(16).density), replicated(mesh))}
    opt = optax.adam(1e-2)
    istate = InverseState(
        params,
        jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)),
                     opt.init(params)),
        jnp.zeros((), jnp.int32))
    step = make_spectral_prb_step(opt, steps=4, n_bins=12,
                                  wrt=frozenset({"density"}),
                                  scatter_stride=2)
    target = jax.device_put(jnp.zeros((RES, RES, 3), jnp.float32),
                            row_sharding(mesh, 3, 0))
    seeds = jax.device_put(jnp.asarray([21, 22], jnp.uint32),
                           replicated(mesh))
    base_ctx = renderer.ctx(cam, 5)
    state0 = renderer.reset(cam, 5)
    with mesh:
        istate, loss = step(istate, state0, base_ctx, seeds, target)

    from jax.experimental import multihost_utils

    img_global = multihost_utils.process_allgather(img, tiled=True)
    # the updated density is replicated: every process holds a full copy
    # in its addressable shards — no gather needed
    dens = np.asarray(istate.params["density"].addressable_shards[0].data)
    return (np.asarray(img_global), float(loss),
            float(np.linalg.norm(dens)))


def worker(process_id: int):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    # the bootstrap path under test: initialize_distributed reads these
    os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{PORT}"
    os.environ["JAX_NUM_PROCESSES"] = "2"
    os.environ["JAX_PROCESS_ID"] = str(process_id)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from vpt_tpu.parallel.scaling import initialize_distributed

    assert initialize_distributed() is True
    assert jax.process_count() == 2
    assert len(jax.devices()) == 8
    assert len(jax.local_devices()) == 4

    from vpt_tpu.parallel.mesh import ray_mesh

    mesh = ray_mesh(8)
    img, loss, dens_norm = render_and_step(mesh)
    print(json.dumps(dict(process=process_id,
                          image_sum=float(img.sum()),
                          image_sha=__import__("hashlib").sha256(
                              img.tobytes()).hexdigest(),
                          loss=loss, dens_norm=dens_norm)))
    jax.distributed.shutdown()


def single_process_reference():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from vpt_tpu.parallel.mesh import ray_mesh

    img, loss, dens_norm = render_and_step(ray_mesh(8))
    print(json.dumps(dict(
        image_sha=__import__("hashlib").sha256(img.tobytes()).hexdigest(),
        image_sum=float(img.sum()), loss=loss, dens_norm=dens_norm)))


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]))
        return
    if len(sys.argv) > 1 and sys.argv[1] == "--reference":
        single_process_reference()
        return

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                        "JAX_PROCESS_ID")}
    env["VPT_MP_PORT"] = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    outs = []
    ok = True
    for i, p in enumerate(procs):
        out, err = p.communicate(timeout=900)
        if p.returncode != 0:
            ok = False
            print(f"worker {i} rc={p.returncode}\n{err[-2000:]}",
                  file=sys.stderr)
        else:
            outs.append(json.loads(out.strip().splitlines()[-1]))

    ref = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--reference"],
        capture_output=True, text=True, timeout=900, env=env)
    if ref.returncode != 0 or not ref.stdout.strip():
        print(f"reference rc={ref.returncode}\n{ref.stderr[-2000:]}",
              file=sys.stderr)
        sys.exit(1)
    refj = json.loads(ref.stdout.strip().splitlines()[-1])

    result = dict(ok=ok, workers=outs, reference=refj)
    if ok:
        # both processes assembled the same global image, and it is
        # bit-identical to the single-process 8-device render
        assert outs[0]["image_sha"] == outs[1]["image_sha"], outs
        assert outs[0]["image_sha"] == refj["image_sha"], (outs, refj)
        assert abs(outs[0]["loss"] - refj["loss"]) < 1e-6
        assert abs(outs[0]["dens_norm"] - refj["dens_norm"]) < 1e-4
        result["bit_identical_across_processes"] = True
    print(json.dumps(result))
    with open("MULTIPROCESS.json", "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
