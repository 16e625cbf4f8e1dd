"""Volume: a density grid assembled from reader blocks, ready for sampling.

JAX equivalent of Volume.js / WebGPUVolume.js: instead of a 3D GPU
texture + hardware sampler, the density grid is a device array sampled
explicitly (nearest / trilinear / quasi-cubic) inside the render kernels.
Block streaming (WebGPUVolume.js:66-93: per-placement writeTexture) becomes
host-side numpy assembly followed by one device upload.

Index convention: density[z, y, x] (z-major like the slice-block stream);
normalized texture coordinate (u,v,w) maps to (x,y,z)/dims like a GPU 3D
texture with linear filtering and clamp-to-edge addressing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from vpt_tpu.scene import io


@dataclass
class Volume:
    """A scalar density volume in [0,1], shape (depth, height, width)."""

    density: np.ndarray  # float32 (D, H, W) in [0, 1]
    filter: str = "linear"  # 'linear' | 'nearest' | 'quasicubic'

    def __post_init__(self):
        assert self.density.ndim == 3, "density must be (D, H, W)"

    @property
    def shape(self):
        return self.density.shape

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_raw_file(
        path: str,
        width: int,
        height: int,
        depth: int,
        progress: Optional[Callable[[float], None]] = None,
        use_native: bool = True,
    ) -> "Volume":
        """Load a headerless uint8 RAW volume.

        Uses the native mmap+threads loader (native/vptio.cpp) when built and
        no per-block progress is requested; the pure-Python block reader is
        the fallback (both produce identical arrays)."""
        if use_native and progress is None:
            from vpt_tpu.scene import native_io

            if native_io.available():
                return Volume(density=native_io.load_raw_f32(path, width, height, depth))
        reader = io.RAWReader(io.FileLoader(path), width, height, depth)
        return Volume.from_reader(reader, progress=progress)

    @staticmethod
    def from_reader(reader, progress: Optional[Callable[[float], None]] = None) -> "Volume":
        """Assemble from any reader exposing read_metadata/read_block.

        Handles the reference's per-placement block placement
        (Volume.js:62-74): each block is written at its (x,y,z) position.
        """
        meta = reader.read_metadata()
        modality = meta["modalities"][0]
        dims = modality["dimensions"]
        W, H, D = dims["width"], dims["height"], dims["depth"]
        out = np.zeros((D, H, W), dtype=np.uint8)
        placements = modality["placements"]
        for n, placement in enumerate(placements):
            i = placement["index"]
            pos = placement["position"]
            block_meta = meta["blocks"][i]
            bd = block_meta["dimensions"]
            data = np.frombuffer(reader.read_block(i), dtype=np.uint8).reshape(
                bd["depth"], bd["height"], bd["width"]
            )
            z, y, x = pos["z"], pos["y"], pos["x"]
            out[z : z + bd["depth"], y : y + bd["height"], x : x + bd["width"]] = data
            if progress is not None:
                progress((n + 1) / len(placements))
        return Volume(density=out.astype(np.float32) / 255.0)

    @staticmethod
    def from_bvp_file(path: str, progress=None) -> "Volume":
        return Volume.from_reader(io.BVPReader(io.FileLoader(path)), progress=progress)

    # -- procedural test volumes (parity: generate_test_volume.ipynb) ------
    @staticmethod
    def sphere_in_cube(size: int = 128) -> "Volume":
        """sphere(r=0.5,+155) inside cube(half-width 0.8,+100), uint8."""
        v = np.zeros((size, size, size), dtype=np.uint8)
        x, y, z = np.meshgrid(
            *([np.linspace(-1, 1, size)] * 3), indexing="ij"
        )
        v[x**2 + y**2 + z**2 < 0.5**2] += 155
        v[np.maximum(np.abs(x), np.maximum(np.abs(y), np.abs(z))) < 0.8] += 100
        return Volume(density=v.astype(np.float32) / 255.0)

    @staticmethod
    def two_spheres(size: int = 128) -> "Volume":
        v = np.zeros((size, size, size), dtype=np.uint8)
        x, y, z = np.meshgrid(*([np.linspace(-1, 1, size)] * 3), indexing="ij")
        v[x**2 + y**2 + (z - 0.5) ** 2 < 0.4**2] += 200
        v[x**2 + y**2 + (z + 0.5) ** 2 < 0.4**2] += 100
        return Volume(density=v.astype(np.float32) / 255.0)

    @staticmethod
    def sparse_spheres(size: int = 256, count: int = 8, radius: float = 0.08,
                       seed: int = 7) -> "Volume":
        """A few small dense spheres in empty space (~0.1-2% occupancy):
        the sparse-scene regime where per-path step count — not per-step
        cost — dominates, i.e. where the super-voxel majorant accelerator
        (ops/majorant) earns its keep. Deterministic placement."""
        rng = np.random.default_rng(seed)
        v = np.zeros((size, size, size), dtype=np.float32)
        grid = np.linspace(-1, 1, size)
        x, y, z = np.meshgrid(grid, grid, grid, indexing="ij")
        for _ in range(count):
            c = rng.uniform(-0.7, 0.7, 3)
            v[(x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2
              < radius ** 2] = 1.0
        return Volume(density=v)
