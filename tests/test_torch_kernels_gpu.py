"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one. The file imports
neither JAX nor crfr, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from crfr_torch.device import strict_fp32
from crfr_torch.ops import fused_preprocess as fp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with strict_fp32():
        yield torch.device("cuda")


def _pixels(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("out_dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("mode", ["pil", "cv2"])
def test_degrade_kernel_matches_plain(cuda, mode, in_dtype, out_dtype, atol):
    x = _pixels((64, 112, 112, 3), in_dtype, cuda)
    before = fp.fused_degrade_normalize.launches
    got = fp.fused_degrade_normalize(x, 16, mode, out_dtype)
    want = fp.fused_degrade_normalize_reference(x, 16, mode, out_dtype)
    torch.cuda.synchronize()
    assert fp.fused_degrade_normalize.launches == before + 1
    assert got.dtype == out_dtype and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("shape,out_hw", [((8, 160, 140, 3), (112, 112)),
                                          ((5, 37, 200, 3), (112, 96))])
def test_resize_kernel_matches_plain(cuda, shape, out_hw):
    x = _pixels(shape, torch.float32, cuda)
    before = fp.fused_resize_normalize.launches
    got = fp.fused_resize_normalize(x, out_hw, "pil", torch.float32)
    want = fp.fused_resize_normalize_reference(x, out_hw, "pil", torch.float32)
    torch.cuda.synchronize()
    assert fp.fused_resize_normalize.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(TypeError, match="uint8 or float32"):
        fp.fused_degrade_normalize(_pixels((1, 16, 16, 3), torch.int32, cuda), 8)
    with pytest.raises(ValueError, match="contiguous"):
        x = _pixels((1, 16, 16, 6), torch.uint8, cuda)[..., ::2]
        fp.fused_degrade_normalize(x, 8)
    with pytest.raises(ValueError, match="limit"):
        fp.fused_resize_normalize(_pixels((1, 400, 400, 3), torch.uint8, cuda), (112, 112))
