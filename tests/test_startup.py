"""Start-up behaviour that needs no card: where the compile cache goes, and
chip_smoke.py refusing to report success without a GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import vgtpu

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("env, want", [
    ({}, str(REPO / ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None),
    ({"VGTPU_NO_COMPILE_CACHE": "1"}, None),
])
def test_compile_cache_dir(env, want):
    """Inside the checkout by default; JAX's own variable wins, and the
    test suite's opt-out sets nothing."""
    assert vgtpu._cache_dir(env) == want


def test_chip_smoke_phase_selection():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    assert chip_smoke.phase_names([]) == chip_smoke.PHASES
    assert chip_smoke.phase_names(["--four-cards"]) == ["device", "four-cards"]
    assert "four-cards" not in chip_smoke.PHASES


def test_chip_smoke_fails_without_gpu(tmp_path):
    """On the CPU the script exits non-zero and its last line is not the
    success record; alone in a directory it fails too."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    last = (out.stdout.strip().splitlines() or [""])[-1]
    assert '"ok": true' not in last
    assert "phase 1 device: FAILED" in out.stdout

    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout.strip() or "-")
