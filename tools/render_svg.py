#!/usr/bin/env python
"""Rasterize an SVG file to PNG through the engine — the classic end-user
task (the reference has no equivalent utility; its tiger render lives in an
external example app, README.md:35).

    python tools/render_svg.py input.svg output.png [--scale S] [--width W]
        [--ss N] [--background r,g,b,a] [--no-aa]

--width sets the output pixel width (height follows the aspect ratio);
--scale multiplies the SVG's own size; --ss 2|4 enables the conflation-free
supersampled coverage mode (ContextConfig.coverage_supersample).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("svg", help="input .svg path")
    ap.add_argument("png", help="output .png path")
    ap.add_argument("--scale", type=float, default=None,
                    help="multiply the SVG's intrinsic size")
    ap.add_argument("--width", type=int, default=None,
                    help="output width in px (overrides --scale)")
    ap.add_argument("--ss", type=int, default=1, choices=(1, 2, 4),
                    help="conflation-free y-supersampling factor")
    ap.add_argument("--background", default="1,1,1,1",
                    help="r,g,b,a floats in [0,1] (default white)")
    ap.add_argument("--no-aa", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU backend")
    args = ap.parse_args()

    try:
        bg = tuple(float(v) for v in args.background.split(","))
    except ValueError:
        bg = ()
    if len(bg) != 4:
        sys.exit("--background needs 4 comma-separated floats")
    if args.scale is not None and args.scale <= 0:
        sys.exit("--scale must be positive")

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    import vgtpu as vg
    from vgtpu.raster.frame import image_to_u8
    from vgtpu.scenes.svg import load_svg, render_svg

    doc = load_svg(args.svg)
    if not doc.paths:
        sys.exit(f"{args.svg}: no drawable paths found")
    if doc.width <= 0 or doc.height <= 0:
        sys.exit(f"{args.svg}: no usable size (no width/height or viewBox)")
    scale = args.scale if args.scale is not None else 1.0
    if args.width:
        scale = args.width / doc.width
    w = max(1, int(round(doc.width * scale)))
    h = max(1, int(round(doc.height * scale)))

    cfg = vg.ContextConfig(coverage_supersample=args.ss)
    ctx = vg.createContext(cfg)
    t0 = time.perf_counter()
    vg.begin(ctx, 0, w, h, 1.0)
    if scale != 1.0:
        vg.transformScale(ctx, scale, scale)
    render_svg(ctx, doc, aa=not args.no_aa)
    img = vg.end(ctx, background=bg)
    arr = image_to_u8(np.asarray(img))
    dt = (time.perf_counter() - t0) * 1e3
    try:
        from PIL import Image
    except ImportError:
        sys.exit("PIL is required to write PNGs")
    Image.fromarray(arr).save(args.png)
    print(f"{args.png}: {w}x{h} ({len(doc.paths)} paths) in {dt:.0f} ms "
          f"on {__import__('jax').devices()[0].platform}")


if __name__ == "__main__":
    main()
