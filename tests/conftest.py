"""Test config: JAX on a virtual 8-device CPU platform, so sharding tests
run without accelerators (set before jax is imported).  JAX_PLATFORMS from
the environment wins: the card-only tests (tests/test_chip.py, marker
`gpu`) run on a GPU machine with JAX_PLATFORMS=cuda,cpu.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# tests leave the persistent compile cache alone (vgtpu._cache_dir)
os.environ["VGTPU_NO_COMPILE_CACHE"] = "1"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture(autouse=True)
def _mmap_pressure_guard():
    """XLA:CPU JIT-loads every compiled executable as several mmaps, and the
    full suite (~300 tests, thousands of fresh-shape compiles in ONE process)
    exhausts the kernel's vm.max_map_count (default 65530) — LLVM then
    SEGFAULTS on the failed mmap (reproduced twice; /proc/self/maps read
    65335 lines at the crash; the earlier 'cache deserialize segfault'
    diagnosis was this same exhaustion).  Flush jax's executable caches when
    the process nears the limit; under pressure cross-test compile reuse is
    sacrificed, below it nothing changes."""
    yield
    try:
        with open("/proc/self/maps", "rb") as f:
            n = sum(1 for _ in f)
    except OSError:
        return
    if n > 45_000:
        import ctypes
        import gc

        jax.clear_caches()
        gc.collect()
        try:  # release glibc arena retention (freed buffers keep their maps)
            ctypes.CDLL("libc.so.6").malloc_trim(0)
        except OSError:
            pass
