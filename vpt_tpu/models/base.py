"""Renderer protocol + string-keyed factory.

JAX shape of the reference's renderer layer
(renderers/AbstractRenderer.js:56-112 + factory dispatch,
WebGPURendererFactory.js:35-50): a renderer is a pair of pure jitted
functions over an explicit state pytree —

    reset(ctx)          -> state                 (restart accumulation)
    render(state, ctx)  -> (state, hdr_image)    (one progressive dispatch)

where ``ctx`` bundles the scene resources (volume, transfer function, light,
camera matrix, seed) and the config dataclass. Progressive accumulation =
calling ``render`` repeatedly; any config/camera change = call ``reset``
(the reference's reset-on-change contract). The returned image is linear HDR
(H, W, 3); tone mapping is a separate stage (postprocess/).
"""

from __future__ import annotations

from typing import Callable, Dict

RENDERERS: Dict[str, Callable] = {}


def register_renderer(key: str):
    def wrap(cls):
        RENDERERS[key] = cls
        cls.key = key
        return cls

    return wrap


def make_renderer(key: str, *args, **kw):
    """Factory dispatch by string key (RendererFactory.js:10-23)."""
    try:
        cls = RENDERERS[key]
    except KeyError:
        raise ValueError(f"unknown renderer {key!r}; known: {sorted(RENDERERS)}")
    return cls(*args, **kw)
