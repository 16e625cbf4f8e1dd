"""Sample streams x device mesh: the two throughput features must compose.

With streams>1 the 4-D (B, S, H, W) radiance/
transmittance leaves silently fell back to `replicated` while the 3-D lane
leaves sharded — inconsistent placement, untested. These tests pin that

  - shard_spectral_state shards the framebuffer H axis of EVERY leaf rank
    ((H,W), (S,H,W), (B,H,W), (B,S,H,W)),
  - a streams=4 render on an 8-device mesh is bit-identical to the
    single-device render (the mesh-shape reproducibility contract), and
  - slab mode accepts streams too (bit-identical to replicated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vpt_tpu.models import mcm_spectral as M
from vpt_tpu.ops import interp
from vpt_tpu.parallel import slab
from vpt_tpu.parallel.mesh import ray_mesh, replicated, shard_spectral_state
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig

RES = 16
VOL = 16
STREAMS = 4


def _renderer(streams=STREAMS, **kw):
    return M.MCMSpectralRenderer(
        Volume.sphere_in_cube(VOL), MaterialTF.constant(0.8, 0.6, 0.2),
        LightConfig(direction=(1.0, 0.2, 0.3)),
        SpectrumConfig(), MCMSpectralConfig(extinction=20.0, steps=6),
        resolution=RES, streams=streams, **kw,
    )


def test_shard_spectral_state_shards_every_rank():
    mesh = ray_mesh(8)
    renderer = _renderer()
    state = shard_spectral_state(renderer.reset(Camera(), 3), mesh)
    for name, leaf in state._asdict().items():
        spec = leaf.sharding.spec
        h_axis = leaf.ndim - 2
        assert spec[h_axis] == "rays", (name, leaf.shape, spec)
        assert all(s is None for i, s in enumerate(spec) if i != h_axis), (
            name, leaf.shape, spec,
        )


@pytest.mark.parametrize("n_devices", [2, 8])
def test_streams_render_bit_identical_across_mesh(n_devices):
    renderer = _renderer()
    cam = Camera()

    ctx = renderer.ctx(cam, 7)
    state = renderer.reset(cam, 7)
    ref_state, ref_img = M.render(state, ctx, steps=6, n_bins=12)
    ref_img = np.asarray(ref_img)

    mesh = ray_mesh(n_devices)
    ctx2 = jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)),
                        renderer.ctx(cam, 7))
    state2 = shard_spectral_state(renderer.reset(cam, 7), mesh)
    out_state, out_img = M.render(state2, ctx2, steps=6, n_bins=12)
    np.testing.assert_array_equal(np.asarray(out_img), ref_img)
    np.testing.assert_array_equal(
        np.asarray(out_state.samples), np.asarray(ref_state.samples)
    )
    # the big accumulator leaf must actually be sharded, not replicated
    assert out_state.radiance.sharding.spec[2] == "rays"


def test_streams_render_many_on_mesh_matches_single_device():
    renderer = _renderer()
    cam = Camera()
    seeds = jnp.asarray([11, 222, 3333], jnp.uint32)

    state = renderer.reset(cam, 7)
    ctx = renderer.ctx(cam, 7)
    _, ref_img = M.render_many(state, ctx, seeds, steps=6, n_bins=12)
    ref_img = np.asarray(ref_img)

    mesh = ray_mesh(8)
    ctx2 = jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)),
                        renderer.ctx(cam, 7))
    state2 = shard_spectral_state(renderer.reset(cam, 7), mesh)
    _, out_img = M.render_many(state2, ctx2, seeds, steps=6, n_bins=12)
    np.testing.assert_array_equal(np.asarray(out_img), ref_img)


def test_mesh_session_matches_single_device(tmp_path):
    """RenderSession(mesh=...) — the public multi-device runtime — renders
    bit-identically to a single-device session, and checkpoints round-trip
    across mesh shapes."""
    from vpt_tpu.session import RenderSession

    def make(mesh=None):
        return RenderSession(
            "mcm-spectral",
            Volume.sphere_in_cube(VOL), MaterialTF.constant(0.8, 0.6, 0.2),
            LightConfig(direction=(1.0, 0.2, 0.3)),
            SpectrumConfig(), MCMSpectralConfig(extinction=20.0, steps=6),
            resolution=RES, streams=2, base_seed=42, mesh=mesh,
        )

    single = make().run(3)
    sharded = make(ray_mesh(8)).run(3)
    np.testing.assert_array_equal(sharded.hdr_image(), single.hdr_image())
    # state is actually distributed
    assert sharded.state.radiance.sharding.spec[2] == "rays"

    # checkpoint saved from the 8-device session resumes on a 2-device one
    path = str(tmp_path / "ckpt.npz")
    sharded.save_checkpoint(path)
    resumed = make(ray_mesh(2)).load_checkpoint(path).run(2)
    np.testing.assert_array_equal(
        resumed.hdr_image(), single.run(2).hdr_image()
    )


@pytest.mark.parametrize("n_devices", [2, 8])
def test_slab_render_with_streams_bit_identical(n_devices):
    renderer = _renderer()
    cam = Camera()
    volume = Volume.sphere_in_cube(VOL)

    ctx = renderer.ctx(cam, 5)
    state = renderer.reset(cam, 5)
    ref_state, ref_img = M.render(state, ctx, steps=6, n_bins=12)
    ref_img = np.asarray(ref_img)

    mesh = ray_mesh(n_devices)
    packed_np = interp.pack_volume_corners(volume.density)
    padded = slab.pad_packed_for_slabs(packed_np, n_devices)
    ctx2 = renderer.ctx(cam, 5)._replace(
        density=slab.shard_packed_volume(padded, mesh)
    )
    ctx2 = ctx2._replace(
        **{f: jax.device_put(getattr(ctx2, f), replicated(mesh))
           for f in ("inv_mvp", "seed_bits", "extinction", "blur", "max_bounces",
                      "light_direction", "material_tf", "light_spectrum",
                      "boundaries", "bin_xyz")}
    )
    state2 = shard_spectral_state(renderer.reset(cam, 5), mesh)
    out_state, out_img = slab.render_slab(
        state2, ctx2, mesh, volume_dims=volume.density.shape, steps=6, n_bins=12
    )
    np.testing.assert_array_equal(np.asarray(out_img), ref_img)
    np.testing.assert_array_equal(
        np.asarray(out_state.samples), np.asarray(ref_state.samples)
    )
