"""chip_smoke.py's phases at a tiny size on the CPU (kernels in the Pallas
interpreter); on a GPU the script runs them at full size."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

SHAPE = (16, 128)


def test_device_phase_refuses_a_cpu(capsys):
    """No GPU: main() fails before any phase and prints no result line."""
    assert jax.devices()[0].platform != "gpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_goldens_phase():
    chip_smoke.phase_goldens(jax.devices("cpu")[0])


def test_main_path_phase():
    chip_smoke.phase_main_path(shape=SHAPE, nt=4, chunk=2, check=(8, 64),
                               interpret=True)


def test_kernels_phase():
    chip_smoke.phase_kernels(shape=SHAPE, interpret=True, reps=1)


def test_four_device_phase():
    """The --four path on four of the virtual CPU devices."""
    chip_smoke.phase_four(shape=SHAPE, nt=4, chunk=2, n=4, interpret=True)


@pytest.mark.gpu
def test_kernels_phase_compiled_on_gpu(gpu):
    """The compiled Triton kernels against the jit path on the card."""
    chip_smoke.phase_kernels(shape=(64, 256), reps=2)
