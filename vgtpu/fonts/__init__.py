"""Text subsystem: TrueType reading, glyph atlas, layout.

DEFAULT_FONT_PATH is DejaVu Sans, shipped with the package (license in
LICENSE_DEJAVU beside it) so text renders the same on every machine."""

import os

DEFAULT_FONT_PATH = os.path.join(os.path.dirname(__file__), "DejaVuSans.ttf")


def default_font_data() -> bytes:
    with open(DEFAULT_FONT_PATH, "rb") as f:
        return f.read()
