"""Native libvptio parity vs the pure-Python readers."""

import numpy as np
import pytest

from vpt_tpu.scene import io, native_io
from vpt_tpu.ops import interp

def test_native_zip_matches_python(native_lib, tmp_path):
    path = str(tmp_path / "t.zip")
    files = {"a.txt": b"hello", "dir/b.bin": bytes(range(256)) * 10,
             "manifest.json": b'{"x": 1}'}
    io.write_stored_zip(path, files)

    z_native = native_io.NativeZip(path)
    z_python = io.ZIPReader(io.FileLoader(path))
    assert sorted(z_native.get_files()) == sorted(z_python.get_files())
    for name, data in files.items():
        assert z_native.read_file(name) == data
        assert z_python.read_file(name) == data
    with pytest.raises(FileNotFoundError):
        z_native.read_file("missing")


def test_native_raw_matches_python(native_lib, tmp_path):
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 256, size=(6, 7, 8), dtype=np.uint8)
    path = str(tmp_path / "v.raw")
    vol.tofile(path)

    native = native_io.load_raw_f32(path, width=8, height=7, depth=6)
    from vpt_tpu.scene.volume import Volume

    python = Volume.from_raw_file(path, width=8, height=7, depth=6).density
    np.testing.assert_array_equal(native, python)


def test_native_pack_corners_matches_python(native_lib):
    rng = np.random.default_rng(1)
    vol = rng.uniform(size=(5, 6, 7)).astype(np.float32)
    native = native_io.pack_corners_f32(vol)
    python = interp.pack_volume_corners(vol)
    np.testing.assert_array_equal(native, python)
