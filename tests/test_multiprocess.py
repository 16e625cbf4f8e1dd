"""Real jax.distributed coverage: the 2-process loopback
dryrun — coordinator bootstrap, cross-process 8-device mesh, sharded render
and a training step through the public APIs — must produce results
bit-identical to the single-process 8-device run (the mesh-shape
determinism contract across process boundaries)."""

import json
import os
import subprocess
import sys


def test_two_process_dryrun_bit_identical():
    tool = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "multiprocess_dryrun.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                        "JAX_PROCESS_ID")}
    out = subprocess.run([sys.executable, tool], capture_output=True,
                         text=True, timeout=900, env=env,
                         cwd=os.path.dirname(tool))
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["ok"] is True
    assert result["bit_identical_across_processes"] is True
    shas = {w["image_sha"] for w in result["workers"]}
    assert shas == {result["reference"]["image_sha"]}
