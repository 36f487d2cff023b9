"""The port's CUDA kernels against their plain versions, on the card: the
preprocessing kernel and ``bank_tilemax`` with the fused gallery path.

These tests need a CUDA device and skip without one. The file imports
neither JAX nor crfr, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from crfr_torch.device import strict_fp32
from crfr_torch.ops import bank_scan as bs
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


def _bank(n, m, d, invalid, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    pq = torch.randint(-127, 128, (n, d), generator=g, device=device, dtype=torch.int8)
    q = torch.randint(-127, 128, (m, d), generator=g, device=device, dtype=torch.int8)
    sc = torch.rand(m, generator=g, device=device) * 1e-2
    valid = torch.rand(m, generator=g, device=device) >= invalid
    return pq, q, sc, valid


@pytest.mark.parametrize("d", [64, 512])
@pytest.mark.parametrize("n", [1, 7, 256])
@pytest.mark.parametrize("m,invalid", [(1 << 16, 0.0), ((1 << 16) - 77, 0.01), (300, 0.5)])
def test_bank_tilemax_equals_plain(cuda, n, d, m, invalid):
    """Exactly equal: s32 sums are exact, the score is one rounded multiply."""
    pq, q, sc, valid = _bank(n, m, d, invalid, cuda, seed=n + d + m)
    before = bs.bank_tilemax.launches
    got = bs.bank_tilemax(pq, q, sc, valid)
    want = bs.bank_tilemax_reference(pq, q, sc, valid)
    torch.cuda.synchronize()
    assert bs.bank_tilemax.launches == before + 1
    assert got.shape == (n, -(-m // 128)) and got.dtype == torch.float32
    assert torch.equal(got, want)


def test_fused_path_equals_scan_on_card(cuda):
    """The three-phase path through the kernel against the int8 scan, on
    noisy copies of planted unit rows: top-1 the planted row, labels equal
    outside groups of equal scores, scores within 1e-6."""
    from crfr_torch.eval.bank import QuantBank, quantize_bank, streaming_topk_q, topk_matches_bank

    g = torch.Generator(device=cuda).manual_seed(5)
    rows = torch.nn.functional.normalize(torch.randn(40000, 512, generator=g, device=cuda), dim=1)
    bank = quantize_bank(rows.cpu().numpy()).to_device(cuda)
    planted = torch.randperm(40000, generator=g, device=cuda)[:64]
    probes = rows[planted] + 0.02 * torch.randn(64, 512, generator=g, device=cuda)
    before = bs.bank_tilemax.launches
    fs, fl = bs.bank_topk_fused(probes, bank.q, bank.scale, bank.labels, k=10)
    ss, sl = streaming_topk_q(probes, bank.q, bank.scale, bank.labels, k=10, block=8192)
    torch.cuda.synchronize()
    assert bs.bank_tilemax.launches == before + 1
    assert torch.equal(fl[:, 0], planted)
    torch.testing.assert_close(fs, ss, atol=1e-6, rtol=0)
    tie = torch.zeros_like(ss, dtype=torch.bool)
    tie[:, 1:] |= ss[:, 1:] == ss[:, :-1]
    tie[:, :-1] |= ss[:, :-1] == ss[:, 1:]
    assert torch.equal(fl[~tie], sl[~tie])
    _, lab = topk_matches_bank(probes, bank, k=10)          # CUDA default: fused
    assert bs.bank_tilemax.launches == before + 2
    assert isinstance(bank, QuantBank) and (lab == fl.cpu().numpy()).all()


def test_bank_tilemax_refuses_what_it_does_not_take(cuda):
    pq, q, sc, valid = _bank(8, 1000, 64, 0.0, cuda)
    with pytest.raises(TypeError, match="int8"):
        bs.bank_tilemax(pq.to(torch.int32), q, sc, valid)
    with pytest.raises(TypeError, match="bool"):
        bs.bank_tilemax(pq, q, sc, valid.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        bs.bank_tilemax(pq, _bank(8, 1000, 128, 0.0, cuda)[1][:, ::2], sc, valid)
    with pytest.raises(ValueError, match="multiple of 16"):
        bs.bank_tilemax(pq[:, :40].contiguous(), q[:, :40].contiguous(), sc, valid)
    big_pq, big_q, _, _ = _bank(8, 1000, 1040, 0.0, cuda)
    with pytest.raises(ValueError, match="at most 1024"):
        bs.bank_tilemax(big_pq, big_q, sc, valid)
    with pytest.raises(ValueError, match="tiles of 128"):
        bs.bank_tilemax(pq, q, sc, valid, tile=64)
    with pytest.raises(ValueError, match="is on"):
        bs.bank_tilemax(pq, q.cpu(), sc, valid)
