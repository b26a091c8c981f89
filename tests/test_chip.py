"""The card-only checks (vgtpu/chipcheck.py, the phases of chip_smoke.py)
as tests.  They skip where JAX finds no GPU; run them on the card with

    python -m pytest tests/test_chip.py -m gpu -q

(tests/conftest.py pins the suite to the CPU unless JAX_PLATFORMS is set,
so give it JAX_PLATFORMS=cuda,cpu there)."""

import pytest

from vgtpu import chipcheck as cc

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
    return cc.device_info()


def test_native_engine(gpu):
    cc.native_engine()


@pytest.mark.parametrize("ss", [1, 2])
def test_main_frame_gpu_matches_cpu(gpu, ss):
    cc.main_frame(ss)


def test_goldens_on_gpu(gpu):
    cc.goldens()


def test_serving_paths_on_gpu(gpu):
    cc.serving_paths()


def test_coverage_kernel_on_gpu(gpu):
    cc.coverage_kernel()
