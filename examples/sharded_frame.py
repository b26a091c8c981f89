#!/usr/bin/env python
"""Render one frame over an n-device mesh — the collective-free layout.

Tiles, entries and edge chunks are co-partitioned host-side
(vgtpu/parallel/sharding.py), so coverage, the chunk->entry reduction and
the composite all run device-local: ZERO collectives in the frame body;
the only cross-device movement is the output framebuffer gather.

Without accelerators, run it on a virtual CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/sharded_frame.py 8

On a machine with several GPUs the same code shards over the cards
(`python examples/sharded_frame.py 4`).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import vgtpu as vg
from vgtpu.parallel.sharding import make_mesh, render_frame_sharded
from vgtpu.scenes.demo_ui import draw_benchmark_frame


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    import jax

    if len(jax.devices()) < n:
        raise SystemExit(
            f"need {n} devices, have {len(jax.devices())} — run with "
            f"JAX_PLATFORMS=cpu XLA_FLAGS="
            f"--xla_force_host_platform_device_count={n}")

    bg = (0.12, 0.12, 0.13, 1.0)
    ctx = vg.createContext()
    vg.begin(ctx, 0, 1920, 1080, 1.0)
    draw_benchmark_frame(ctx, 0.0)
    single = np.asarray(vg.end(ctx, background=bg))

    mesh = make_mesh(n)
    img, meta = render_frame_sharded(
        ctx.last_plan, ctx.last_device_arrays, mesh, background=bg,
        return_meta=True)
    img = np.asarray(img)

    diff = float(np.abs(img - single).max())
    print(f"devices={n}  max|sharded - single|={diff:.2e}")
    print(f"chunk balance={meta['chunk_balance']:.3f}  "
          f"entry balance={meta['entry_balance']:.3f}  "
          f"collective bytes in frame body={meta['collective_bytes_per_frame']}")
    assert diff <= 1e-5
    try:
        from PIL import Image

        out = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(out, "RGBA").save("/tmp/vgtpu_sharded.png")
        print("wrote /tmp/vgtpu_sharded.png")
    except Exception:  # noqa: BLE001 — PIL optional
        pass


if __name__ == "__main__":
    main()
