"""Card-only checks: the compiled SGM aggregation kernel at full width.

These skip without an NVIDIA GPU (the Triton kernel has no compiled form on
the CPU; its arithmetic is covered in interpret mode by test_sgm_kernel*.py).
chip_smoke.py runs the same check. On the card:
JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_on_card.py
"""

import pytest

import chip_smoke


@pytest.mark.gpu
@pytest.mark.parametrize("W,H,D", [(1280, 720, 128), (1280, 720, 192),
                                   (320, 240, 64)])
def test_compiled_kernel_bit_exact(gpu, W, H, D):
    chip_smoke.check_kernel_vs_xla(W, H, D)
