"""Compiled-HLO contracts for the parallel paths.

The zero-communication claim (parallel/mesh.py: a rays-sharded render
dispatch partitions with NO collectives — gathers hit replicated tables,
every lane op is elementwise) was previously asserted only in prose; an
accidentally introduced collective would have passed CI silently. These
tests pin it at the artifact level: lower + compile the sharded programs on
the 8-device virtual mesh and scan the optimized HLO for collective ops.

Slab mode (parallel/slab.py) is the opposite contract: its routed
distributed gather is exactly one all_gather (indices) + one
psum_scatter (row routing) per Woodcock step — no other collective kinds.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vpt_tpu.models import mcm_spectral as M
from vpt_tpu.parallel.mesh import ray_mesh, replicated, shard_spectral_state
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import (
    LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig,
)

RES = 32
STEPS = 4

COLLECTIVE_RE = re.compile(
    r"\b(all-reduce|all-gather|reduce-scatter|collective-permute|all-to-all)"
    r"(-start)?\(")


def _collectives(hlo_text):
    """Sorted list of collective op kinds invoked in an HLO dump."""
    return sorted({m.group(1) for m in COLLECTIVE_RE.finditer(hlo_text)})


def _renderer(streams=1, mesh=None):
    return M.MCMSpectralRenderer(
        Volume.sphere_in_cube(16),
        MaterialTF.constant(albedo=0.8, alpha=0.6, anisotropy_g=0.3),
        LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
        MCMSpectralConfig(extinction=10.0, bounces=4, steps=STEPS),
        resolution=RES, streams=streams, mesh=mesh,
    )


@pytest.mark.parametrize("streams", [1, 4])
def test_sharded_render_compiles_with_zero_collectives(streams):
    mesh = ray_mesh(8)
    r = _renderer(streams=streams, mesh=mesh)
    cam = Camera()
    ctx = r.ctx(cam, 3)
    state = r.reset(cam, 3)
    hlo = M.render.lower(state, ctx, steps=STEPS, n_bins=12).compile().as_text()
    assert _collectives(hlo) == [], (
        f"rays-sharded render must be collective-free, found "
        f"{_collectives(hlo)}")


def test_sharded_render_many_compiles_with_zero_collectives():
    mesh = ray_mesh(8)
    r = _renderer(streams=4, mesh=mesh)
    cam = Camera()
    ctx = r.ctx(cam, 3)
    state = r.reset(cam, 3)
    seeds = jax.device_put(jnp.asarray([1, 2, 3], jnp.uint32),
                           replicated(mesh))
    hlo = M.render_many.lower(
        state, ctx, seeds, steps=STEPS, n_bins=12).compile().as_text()
    assert _collectives(hlo) == [], (
        f"rays-sharded render_many must be collective-free, found "
        f"{_collectives(hlo)}")


def test_slab_render_has_exactly_its_two_collectives():
    from vpt_tpu.parallel import slab
    from vpt_tpu.ops import interp

    mesh = ray_mesh(8)
    vol = Volume.sphere_in_cube(16)
    r = M.MCMSpectralRenderer(
        vol, MaterialTF.constant(albedo=0.8, alpha=0.6, anisotropy_g=0.3),
        LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
        MCMSpectralConfig(extinction=10.0, bounces=4, steps=STEPS),
        resolution=RES, pack_tables={"material_tf", "light_spectrum"},
    )
    cam = Camera()
    packed = slab.pad_packed_for_slabs(
        interp.pack_volume_corners(vol.density), 8)
    ctx = jax.tree.map(
        lambda x: jax.device_put(x, replicated(mesh)), r.ctx(cam, 3))
    ctx = ctx._replace(density=slab.shard_packed_volume(packed, mesh))
    state = shard_spectral_state(r.reset(cam, 3), mesh)
    hlo = slab.render_slab(
        state, ctx, mesh, volume_dims=vol.density.shape, steps=STEPS,
        n_bins=12, lower_only=True).compile().as_text()

    kinds = _collectives(hlo)
    assert "collective-permute" not in kinds and "all-to-all" not in kinds, kinds
    # the routed gather: all_gather(indices) + psum_scatter(rows); XLA may
    # lower psum_scatter as reduce-scatter or all-reduce+slice
    assert "all-gather" in kinds, kinds
    assert ("reduce-scatter" in kinds) or ("all-reduce" in kinds), kinds
    # ... and they appear once each per loop body, not once per step:
    # the steps loop must stay rolled (a while/fori in HLO), so collective
    # op COUNT is independent of `steps`
    n_coll = len(COLLECTIVE_RE.findall(hlo))
    assert n_coll <= 4, (
        f"expected the two per-step collectives (+async start/done forms) "
        f"in one rolled loop body, found {n_coll}")


def test_slab_prb_grads_collective_contract():
    """Slab-sharded packed-PRB gradients: the taped forward pays the
    routed-gather pair per step, the reverse scan pays two all_gathers
    (indices + update rows) per scattered step, the distributed
    contraction exactly one halo collective-permute — all in ROLLED
    loops, so the collective count is independent of `steps`."""
    from vpt_tpu.parallel import slab
    from vpt_tpu.ops import interp

    mesh = ray_mesh(8)
    vol = Volume.sphere_in_cube(16)
    table = np.zeros((256, 256, 4), np.float32)
    table[..., 0] = 0.8
    table[..., 1] = np.linspace(0, 1, 256)[:, None]
    r = M.MCMSpectralRenderer(
        vol, MaterialTF(table),
        LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
        MCMSpectralConfig(extinction=10.0, bounces=4, steps=STEPS),
        resolution=RES, pack_tables=True,
    )
    cam = Camera()
    packed = slab.pad_packed_for_slabs(
        interp.pack_volume_corners(vol.density), 8)
    ctx = jax.tree.map(
        lambda x: jax.device_put(x, replicated(mesh)), r.ctx(cam, 3))
    ctx = ctx._replace(density=slab.shard_packed_volume(packed, mesh))
    state = shard_spectral_state(r.reset(cam, 3), mesh)
    g_img = jnp.ones((RES, RES, 3), jnp.float32)
    hlo = slab.prb_grads_slab(
        state, ctx, mesh, volume_dims=vol.density.shape, g_image=g_img,
        steps=STEPS, n_bins=12, lower_only=True).compile().as_text()

    kinds = _collectives(hlo)
    assert "all-gather" in kinds, kinds
    assert "collective-permute" in kinds, kinds
    assert "all-to-all" not in kinds, kinds
    n_coll = len(COLLECTIVE_RE.findall(hlo))
    assert n_coll <= 14, (
        f"slab-PRB collectives must live in rolled loop bodies "
        f"(count independent of steps); found {n_coll}")


def test_sharded_render_executes_bit_identical_to_single_device():
    """The compiled sharded program must also still be CORRECT (guards the
    guard: a collective-free but wrong partition would fail here)."""
    mesh = ray_mesh(8)
    r1 = _renderer(streams=2)
    cam = Camera()
    s1, img1 = M.render(r1.reset(cam, 7), r1.ctx(cam, 7), steps=STEPS,
                        n_bins=12)
    r8 = _renderer(streams=2, mesh=mesh)
    s8, img8 = M.render(r8.reset(cam, 7), r8.ctx(cam, 7), steps=STEPS,
                        n_bins=12)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img8))
