"""Shared test fonts (one place instead of per-file copies).

FONT_PATH/FONT_DATA are the DejaVu Sans the package ships.  MONO_PATH is
matplotlib's bundled DejaVu Sans Mono (the fallback-font tests), or None
where matplotlib is not installed.
"""

from __future__ import annotations

from pathlib import Path

from vgtpu.fonts import DEFAULT_FONT_PATH

FONT_PATH: Path = Path(DEFAULT_FONT_PATH)
FONT_DATA: bytes = FONT_PATH.read_bytes()


def _mono_path() -> Path | None:
    try:
        import matplotlib
    except ImportError:
        return None
    p = Path(matplotlib.get_data_path()) / "fonts" / "ttf" / "DejaVuSansMono.ttf"
    return p if p.exists() else None


MONO_PATH: Path | None = _mono_path()
