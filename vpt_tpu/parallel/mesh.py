"""Device-mesh sharding: the JAX replacement for the reference's
per-pixel GPU dispatch grid (SURVEY.md §2.10).

Axes:
  - "rays"  — the primary data-parallel axis: framebuffer rows (and with
    them the photon-state lanes) are sharded across devices. Every per-lane
    op is elementwise, so GSPMD partitions the whole render dispatch with
    zero communication; the volume/TF/light resources are replicated and
    gathers stay device-local.

Reproducibility contract: RNG seeds are pure functions of *global* pixel
coordinates (broadcasted_iota has global semantics under GSPMD), so renders
are bit-identical across mesh shapes — including 1 device.

Gradient all-reduce in the inverse-rendering path needs no explicit psum:
differentiating a replicated parameter against a rays-sharded loss makes
XLA insert the all-reduce (NCCL over NVLink) automatically.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def ray_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh over the "rays" axis."""
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.array(devices), ("rays",))


def row_sharding(mesh: Mesh, ndim: int, row_axis: int) -> NamedSharding:
    """Shard dimension ``row_axis`` (the framebuffer H axis) over "rays"."""
    spec = [None] * ndim
    spec[row_axis] = "rays"
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_spectral_state(state, mesh: Mesh):
    """Place a SpectralState so lanes are row-sharded across "rays".

    Lane leaves always end in (..., H, W) — (H, W), (S, H, W) with sample
    streams, (B, H, W) binned, (B, S, H, W) binned+streams — so the
    framebuffer H axis is uniformly ``ndim - 2``. Leaves with fewer than 2
    dims replicate.
    """

    def place(x):
        if x.ndim >= 2:
            s = row_sharding(mesh, x.ndim, x.ndim - 2)
        else:
            s = replicated(mesh)
        return jax.device_put(x, s)

    return jax.tree.map(place, state)


def shard_ctx(ctx, mesh: Mesh):
    """Scene resources are replicated on every device."""
    return jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)), ctx)
