"""RenderSession — the host-side rendering runtime.

JAX shape of the reference's L3 rendering context
(/root/reference/src/js/WebGPURenderingContext.js): renderer/tonemapper
lifecycle (chooseRenderer/chooseToneMapper, :147-179), camera-change ->
reset contract (:41-45), the frame loop (Ticker.js becomes an explicit
dispatch loop), resolution plumbing, and animation recording
(RenderingContext.js:241-349's recordAnimationToImageSequence becomes a
batch render-to-array driver).

Additions over the reference (SURVEY.md §5): deterministic per-frame seeds
(replayable renders), checkpoint/resume of the accumulation state, per-step
metrics (paths/s), and structured logging.
"""

from __future__ import annotations

import hashlib
import logging
import time
from typing import Callable, Optional

import numpy as np

from vpt_tpu.models import make_renderer
from vpt_tpu.postprocess.tonemap import make_tonemapper
from vpt_tpu.scene.camera import Camera

log = logging.getLogger("vpt_tpu.session")


def frame_seed(base_seed: int, frame: int) -> int:
    """Deterministic per-frame seed (replaces the reference's Math.random())."""
    h = hashlib.blake2s(f"{base_seed}:{frame}".encode(), digest_size=4)
    return int.from_bytes(h.digest(), "little")


class RenderSession:
    """Progressive rendering session over one renderer + tonemapper."""

    def __init__(
        self,
        renderer_key: str,
        *renderer_args,
        tonemapper: str = "artistic",
        tonemapper_kw: Optional[dict] = None,
        camera: Optional[Camera] = None,
        base_seed: int = 0,
        mesh=None,
        **renderer_kw,
    ):
        self.renderer_key = renderer_key
        # multi-device sessions: the mesh flows into the renderer, which
        # replicates scene resources and row-shards accumulation state; the
        # frame loop, metrics, and checkpoints below are unchanged (and
        # checkpoints stay mesh-shape independent — test_recovery.py)
        if mesh is not None:
            renderer_kw = dict(renderer_kw, mesh=mesh)
        self.mesh = mesh
        self.renderer = make_renderer(renderer_key, *renderer_args, **renderer_kw)
        self.tonemapper_key = tonemapper
        self.tonemapper = make_tonemapper(tonemapper, **(tonemapper_kw or {}))
        self.camera = camera or Camera()
        self.base_seed = base_seed
        self.frame = 0
        self.state = None
        self.hdr = None
        self._t_total = 0.0
        self.reset()

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        """Restart accumulation (any camera/config change calls this —
        the reference's reset-on-change contract)."""
        self.frame = 0
        self.state = self.renderer.reset(self.camera, frame_seed(self.base_seed, 0))
        self.hdr = None
        log.debug("session reset (renderer=%s)", self.renderer_key)

    def choose_tonemapper(self, key: str, **kw):
        self.tonemapper_key = key
        self.tonemapper = make_tonemapper(key, **kw)

    def set_camera(self, camera: Camera):
        self.camera = camera
        self.reset()

    # -- the frame loop ----------------------------------------------------
    def run(self, frames: int = 1, progress: Optional[Callable] = None):
        """Dispatch ``frames`` progressive render passes.

        Uses the renderer's batched ``render_many`` (one device program for
        all frames) when available and no per-frame progress is requested —
        bit-identical to the sequential path, minus the host overhead."""
        import jax

        t0 = time.perf_counter()
        many = getattr(self.renderer, "render_many", None)
        if many is not None and progress is None and frames > 1:
            seeds = [frame_seed(self.base_seed, self.frame + 1 + k) for k in range(frames)]
            self.frame += frames
            self.state, self.hdr = many(self.state, self.camera, seeds)
        else:
            for _ in range(frames):
                self.frame += 1
                seed = frame_seed(self.base_seed, self.frame)
                self.state, self.hdr = self.renderer.render(self.state, self.camera, seed)
                if progress is not None:
                    progress(self.frame)
        jax.block_until_ready(self.hdr)
        self._t_total += time.perf_counter() - t0
        return self

    # -- outputs -----------------------------------------------------------
    def hdr_image(self) -> np.ndarray:
        assert self.hdr is not None, "run() at least one frame first"
        return np.asarray(self.hdr)

    def image(self) -> np.ndarray:
        """Tone-mapped display image in [0,1]."""
        import jax.numpy as jnp

        return np.asarray(self.tonemapper(jnp.asarray(self.hdr_image())))

    def image_u8(self) -> np.ndarray:
        return (np.clip(self.image(), 0, 1) * 255).astype(np.uint8)

    def metrics(self) -> dict:
        out = {"frames": self.frame, "seconds": self._t_total}
        samples = getattr(self.state, "samples", None)
        if samples is not None:
            s = np.asarray(samples)
            out["spp_mean"] = float(s.mean())
            out["paths"] = int(s.sum())
            if self._t_total > 0:
                out["paths_per_s"] = out["paths"] / self._t_total
        return out

    # -- animation recording ----------------------------------------------
    def record_animation(
        self,
        animator,
        n_frames: int,
        frames_per_pose: int = 16,
        start_time: float = 0.0,
        duration: float = 1.0,
        progress: Optional[Callable] = None,
    ):
        """Render an animation to a list of uint8 images.

        Per pose: animator.apply(camera, t) -> reset -> accumulate
        ``frames_per_pose`` dispatches -> tonemap (the reference's
        recordAnimationToImageSequence loop, RenderingContext.js:253-297).
        """
        images = []
        for i in range(n_frames):
            t = start_time + duration * (i / max(n_frames - 1, 1))
            animator.apply(self.camera, t)
            self.reset()
            self.run(frames_per_pose)
            images.append(self.image_u8())
            if progress is not None:
                progress((i + 1) / n_frames)
        return images

    # -- checkpoint / resume ----------------------------------------------
    def save_checkpoint(self, path: str):
        """Snapshot the accumulation state (resumable progressive render)."""
        import jax

        leaves, treedef = jax.tree.flatten(self.state)
        np.savez(
            path,
            frame=self.frame,
            base_seed=self.base_seed,
            renderer_key=self.renderer_key,
            n_leaves=len(leaves),
            **{f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)},
        )

    def load_checkpoint(self, path: str):
        import jax
        import jax.numpy as jnp

        data = np.load(path, allow_pickle=False)
        assert str(data["renderer_key"]) == self.renderer_key, (
            f"checkpoint was for renderer {data['renderer_key']}, "
            f"session uses {self.renderer_key}"
        )
        template = self.renderer.reset(self.camera, frame_seed(self.base_seed, 0))
        leaves, treedef = jax.tree.flatten(template)
        n = int(data["n_leaves"])
        assert n == len(leaves), "checkpoint structure mismatch"
        new_leaves = []
        for i, old in enumerate(leaves):
            saved = data[f"leaf_{i}"]
            if isinstance(old, (int, float)):  # host-scalar leaves (e.g. DOS depth)
                new_leaves.append(type(old)(saved))
                continue
            old_arr = np.asarray(old)
            assert old_arr.shape == saved.shape and old_arr.dtype == saved.dtype, (
                f"leaf mismatch: {old_arr.shape}/{old_arr.dtype} vs "
                f"{saved.shape}/{saved.dtype}"
            )
            new_leaves.append(jnp.asarray(saved))
        state = jax.tree.unflatten(treedef, new_leaves)
        shard = getattr(self.renderer, "shard_state", None)
        if shard is not None:
            state = shard(state)  # checkpoints are mesh-shape independent
        self.state = state
        self.frame = int(data["frame"])
        self.base_seed = int(data["base_seed"])
        return self
