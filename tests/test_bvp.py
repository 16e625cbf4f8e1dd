"""BVP (ZIP + manifest.json) volume round trip through both reader stacks."""

import json

import numpy as np
import pytest

from vpt_tpu.scene import io, native_io
from vpt_tpu.scene.volume import Volume


def _make_bvp(tmp_path, blocks_layout="slices"):
    """Build a BVP archive for a 4x4x4 volume out of uint8 blocks."""
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 256, size=(4, 4, 4), dtype=np.uint8)

    if blocks_layout == "slices":
        placements = [
            {"index": i, "position": {"x": 0, "y": 0, "z": i}} for i in range(4)
        ]
        blocks = [
            {"url": f"blocks/{i}.raw", "format": "raw",
             "dimensions": {"width": 4, "height": 4, "depth": 1}}
            for i in range(4)
        ]
        files = {f"blocks/{i}.raw": vol[i].tobytes() for i in range(4)}
    else:  # one full block
        placements = [{"index": 0, "position": {"x": 0, "y": 0, "z": 0}}]
        blocks = [{"url": "block.raw", "format": "raw",
                   "dimensions": {"width": 4, "height": 4, "depth": 4}}]
        files = {"block.raw": vol.tobytes()}

    manifest = {
        "meta": {"version": 1},
        "modalities": [{
            "name": "default",
            "dimensions": {"width": 4, "height": 4, "depth": 4},
            "placements": placements,
        }],
        "blocks": blocks,
    }
    files["manifest.json"] = json.dumps(manifest).encode()
    path = str(tmp_path / "vol.bvp")
    io.write_stored_zip(path, files)
    return path, vol


@pytest.mark.parametrize("layout", ["slices", "single"])
def test_bvp_round_trip(tmp_path, layout):
    path, vol = _make_bvp(tmp_path, layout)
    loaded = Volume.from_bvp_file(path)
    np.testing.assert_array_equal(loaded.density, vol.astype(np.float32) / 255.0)


def test_bvp_progress_events(tmp_path):
    path, vol = _make_bvp(tmp_path, "slices")
    seen = []
    Volume.from_bvp_file(path, progress=seen.append)
    assert seen == [0.25, 0.5, 0.75, 1.0]


def test_bvp_native_zip_reads_manifest(native_lib, tmp_path):
    path, vol = _make_bvp(tmp_path, "slices")
    z = native_io.NativeZip(path)
    manifest = json.loads(z.read_file("manifest.json"))
    assert manifest["modalities"][0]["dimensions"]["depth"] == 4
    assert z.read_file("blocks/2.raw") == vol[2].tobytes()
