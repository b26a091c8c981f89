"""vgtpu: a 2D vector-graphics engine on JAX accelerators.

Capability-parity rebuild of jdryg/vg-renderer (see SURVEY.md) as a JAX
pipeline: analytic winding-number coverage rasterization on 8x128-pixel tiles
instead of CPU tessellation + GPU triangles.

Public API mirrors the reference's vg:: namespace (include/vg/vg.h) as free
functions over a Context, so reference users can map calls 1:1.
"""

import os as _os


def _cache_dir(environ=_os.environ):
    """Where vgtpu points JAX's persistent compilation cache, or None to
    leave the setting alone: when JAX_COMPILATION_CACHE_DIR is set JAX reads
    it itself, and VGTPU_NO_COMPILE_CACHE=1 (the test suite) opts out.
    Otherwise a fixed path inside the checkout — the path is part of the
    cache key, so a directory that moves between runs never hits."""
    if environ.get("JAX_COMPILATION_CACHE_DIR") or environ.get(
            "VGTPU_NO_COMPILE_CACHE"):
        return None
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


def _enable_compile_cache() -> None:
    """Persistent compilation cache: a cold process compiles ~10 programs
    per plan shape signature, which dominates its first frame; a warm cache
    cuts that to load time."""
    import jax

    path = _cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    if path is not None or _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        # cache every program: the frame's many small programs each fall
        # under JAX's default size/compile-time thresholds
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


_enable_compile_cache()

from vgtpu.core import (  # noqa: F401
    Color,
    Colors,
    LineCap,
    LineJoin,
    PathType,
    FillRule,
    Winding,
    ClipRule,
    TransformOrder,
    StrokeFlags,
    FillFlags,
    ImageFlags,
    TextAlign,
    TextBoxFlags,
    CommandListFlags,
    FontFlags,
    color4f,
    color4ub,
    colorHSB,
    colorHSL,
    colorSetAlpha,
    colorGetRed,
    colorGetGreen,
    colorGetBlue,
    colorGetAlpha,
    stroke_flags,
    fill_flags,
)
from vgtpu.api.config import ContextConfig  # noqa: F401

from vgtpu.api.context import *  # noqa: F401,F403
from vgtpu.api.context import (  # noqa: F401 (explicit for IDEs)
    Context,
    GradientHandle,
    ImagePatternHandle,
    ImageHandle,
    FontHandle,
    CommandListHandle,
    TextConfig,
    TextRow,
    GlyphPosition,
    isValid,
)

from vgtpu.api.standalone import *  # noqa: F401,F403  (path.h/stroker.h seam)
from vgtpu.api.standalone import Mesh, Stroker, SubPath  # noqa: F401
from vgtpu.raster.batch import (  # noqa: F401  (batched serving)
    VariantBatch,
    measure_batch_ms_per_frame,
)


def debugPrintf(fmt: str, *args) -> None:
    """vg.h VG_TRACE analogue (vg.h:50-56): formatted diagnostic print.

    The reference compiles this to bx::debugPrintf only when VG_CONFIG_DEBUG;
    here it is gated by the VGTPU_DEBUG environment variable."""
    import os as _os
    import sys as _sys

    if _os.environ.get("VGTPU_DEBUG"):
        print("vg " + (fmt % args if args else fmt), file=_sys.stderr)


def debugBreak() -> None:
    """vg.h VG_CHECK's bx::debugBreak analogue (vg.h:62-68): drop into the
    debugger when VGTPU_DEBUG is set, else no-op."""
    import os as _os

    if _os.environ.get("VGTPU_DEBUG"):
        import pdb

        pdb.set_trace()


__version__ = "0.1.0"
