"""crfr_torch.ops.fused_preprocess on the CPU against the Pallas kernels of
crfr.ops.fused_pallas (interpreter mode), at tests/test_pallas.py's shapes
and tolerances: float32 out atol 2e-3 / rtol 1e-3, bf16 out 2e-2. The
kernel itself is held against the same plain versions on the card in
tests/test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crfr.ops import fused_pallas as ref
from crfr_torch.ops import fused_preprocess as port

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
_TOL = {torch.float32: dict(atol=2e-3, rtol=1e-3),
        torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _pixels(rng, shape, dtype):
    return rng.integers(0, 256, shape).astype(dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("mode", ["pil", "cv2"])
def test_degrade_matches_pallas(rng, mode, in_dtype, out_dtype):
    x = _pixels(rng, (3, 112, 112, 3), in_dtype)
    want = ref.fused_degrade_normalize(jnp.asarray(x), 16, mode,
                                       out_dtype=_JNP[out_dtype], interpret=True)
    got = port.fused_degrade_normalize(torch.from_numpy(x), 16, mode,
                                       out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (3, 112, 112, 3)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_TOL[out_dtype])


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_resize_matches_pallas(rng, out_dtype):
    x = _pixels(rng, (2, 160, 140, 3), np.float32)
    want = ref.fused_resize_normalize(jnp.asarray(x), (112, 112), "pil",
                                      out_dtype=_JNP[out_dtype], interpret=True)
    got = port.fused_resize_normalize(torch.from_numpy(x), (112, 112), "pil",
                                      out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (2, 112, 112, 3)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_TOL[out_dtype])


def test_output_is_channels_last_nchw(rng):
    x = torch.from_numpy(_pixels(rng, (2, 32, 32, 3), np.uint8))
    nchw = port.fused_degrade_normalize(x, 8).permute(0, 3, 1, 2)
    assert nchw.is_contiguous(memory_format=torch.channels_last)


def test_cpu_tensor_takes_plain_version_without_counting(rng):
    before = (port.fused_degrade_normalize.launches,
              port.fused_resize_normalize.launches)
    x = torch.from_numpy(_pixels(rng, (2, 32, 32, 3), np.uint8))
    a = port.fused_degrade_normalize(x, 8, out_dtype=torch.float32)
    b = port.fused_resize_normalize(x, (16, 16), out_dtype=torch.float32)
    torch.testing.assert_close(
        a, port.fused_degrade_normalize_reference(x, 8, out_dtype=torch.float32),
        rtol=0, atol=0)
    torch.testing.assert_close(
        b, port.fused_resize_normalize_reference(x, (16, 16), out_dtype=torch.float32),
        rtol=0, atol=0)
    assert (port.fused_degrade_normalize.launches,
            port.fused_resize_normalize.launches) == before


def test_kernel_path_refuses_cpu_tensors(rng):
    x = torch.from_numpy(_pixels(rng, (1, 16, 16, 3), np.uint8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        port._launch(x, ("degrade", 16, 16, 8, "pil"), 16, 16, torch.float32, "t")


def test_non_square_degrade_raises(rng):
    x = torch.from_numpy(_pixels(rng, (1, 16, 12, 3), np.uint8))
    with pytest.raises(ValueError, match="square"):
        port.fused_degrade_normalize(x, 8)
