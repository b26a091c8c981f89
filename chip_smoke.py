#!/usr/bin/env python
"""Smoke test of the frame pipeline on the GPU, in one process.

    python chip_smoke.py                one card: every phase below
    python chip_smoke.py --four-cards   four cards: the sharded paths only

Phases (vgtpu/chipcheck.py holds the checks):
  1 device          JAX sees GPUs (no CPU fallback) and a CPU device
  2 native          the C++ engine and path recorder built from this checkout
  3 main-frame      the 1920x1080 benchmark frame (tiger + UI, with text) at
                    coverage_supersample 1 and 2, GPU vs CPU in this process
  4 goldens         the five capability tiers against tests/goldens
  5 serving         frame memo, paint memo, layer memo, renderFrames,
                    VariantBatch, retained pan, image pattern vs fresh renders
  6 coverage        the frame's coverage formulation vs the XLA scan and the
                    oracle, and the median time of each formulation
  --four-cards      the tile-sharded 3840x2160 frame and a K=8 variant batch
                    over four cards vs the same work on one card

Each phase prints one line.  When every phase passed, the card's name and
power limit and then one JSON line end the output:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Any failure exits non-zero without that line.
"""

from __future__ import annotations

import json
import os
import sys
import time

PHASES = ["device", "native", "main-frame ss=1", "main-frame ss=2", "goldens",
          "serving", "coverage"]


def phase_names(argv) -> list[str]:
    """The phases a command line selects."""
    if "--four-cards" in argv:
        return ["device", "four-cards"]
    return list(PHASES)


def _run(name: str):
    from vgtpu import chipcheck as cc

    return {
        "device": cc.device_info,
        "native": cc.native_engine,
        "main-frame ss=1": lambda: cc.main_frame(1),
        "main-frame ss=2": lambda: cc.main_frame(2),
        "goldens": cc.goldens,
        "serving": cc.serving_paths,
        "coverage": cc.coverage_kernel,
        "four-cards": cc.four_cards,
    }[name]()


def main(argv) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "vgtpu")):
        print("chip_smoke: the vgtpu package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    failed = []
    info = None
    for i, name in enumerate(phase_names(argv), 1):
        t0 = time.perf_counter()
        try:
            res = _run(name)
        except Exception as e:  # noqa: BLE001 - every phase reports, then exit 1
            import traceback

            traceback.print_exc()
            print(f"phase {i} {name}: FAILED ({time.perf_counter() - t0:.1f} s) "
                  f"{type(e).__name__}: {e}", flush=True)
            failed.append(name)
            if name == "device":
                break          # nothing else means anything without the card
            continue
        if name == "device":
            info = res
        print(f"phase {i} {name}: ok ({time.perf_counter() - t0:.1f} s) "
              f"{json.dumps(res, default=str)}", flush=True)
    if failed or info is None:
        print(f"chip_smoke: failed phases: {failed}", flush=True)
        return 1
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["device_kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
