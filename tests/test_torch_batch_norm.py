"""crfr_torch.ops.batch_norm on the CPU: CPU tensors take the plain path
unchanged, bit for bit the ``F.batch_norm`` call with the rescaled running
variance that ``models.irse`` made before the op existed (output, gradients
and the running statistics, moved or left), and never the kernels; the
launch plan the kernels get at IR-50's shapes; and the checks that refuse
what the kernels do not take. The kernels themselves are held against this
plain path on the card in tests/test_torch_kernels_gpu.py."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import pytest
import torch
import torch.nn.functional as F

from crfr_torch.models import irse
from crfr_torch.ops import batch_norm as bn

EPS, MOM = 1e-5, 0.1


def _parent(x, w, b, rm, rv, frozen):
    """``_FlaxStats.forward``'s single-device train path before the op."""
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        rm = rm.clone() if frozen else rm
        rv2 = rv * (n / (n - 1))
    y = F.batch_norm(x, rm, rv2, w, b, True, MOM, EPS)
    if not frozen:
        with torch.no_grad():
            torch.mul(rv2, (n - 1) / n, out=rv)
    return y


def _inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    if len(shape) == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    w = (torch.rand(c, generator=g) + 0.5).requires_grad_(True)
    b = torch.randn(c, generator=g).requires_grad_(True)
    rm, rv = torch.randn(c, generator=g), torch.rand(c, generator=g) + 0.5
    return x, w, b, rm, rv, torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 64, 7, 7), (2, 24, 5, 3), (8, 512, 1, 1), (16, 32)])
def test_cpu_takes_the_plain_path_unchanged(shape, dtype, frozen):
    runs = []
    for fn in (_parent, None):
        x, w, b, rm, rv, dy = _inputs(shape, dtype, seed=sum(shape))
        before = bn.batch_norm.launches
        if fn is None:
            y = bn.batch_norm(x, w, b, rm, rv, MOM, EPS, update=not frozen)
            assert bn.batch_norm.launches == before
        else:
            y = fn(x, w, b, rm, rv, frozen)
        y.backward(dy)
        runs.append((y, x.grad, w.grad, b.grad, rm, rv))
    for got, want in zip(runs[1], runs[0]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    if frozen:
        _, _, _, rm0, rv0, _ = _inputs(shape, dtype, seed=sum(shape))
        assert torch.equal(runs[1][4], rm0) and torch.equal(runs[1][5], rv0)


def test_module_trains_through_the_op():
    """``irse.BatchNorm2d`` in train mode on the CPU: the op's plain path,
    and flax's biased running variance (not torch's unbiased one)."""
    m = irse.BatchNorm2d(16, **irse._BN).train()
    x = torch.randn(3, 16, 4, 4).contiguous(memory_format=torch.channels_last)
    m(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(m.running_var, 0.9 + 0.1 * var, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(m.running_mean, 0.1 * x.mean(dim=(0, 2, 3)),
                               rtol=1e-6, atol=1e-6)


# (C, rows, dtype) → (vec, vb, row_blocks, group) on a 132-SM card
IR50_PLANS = [
    (64, 512 * 112 * 112, torch.bfloat16, (8, 8, 264, 17)),
    (64, 512 * 56 * 56, torch.bfloat16, (8, 8, 264, 17)),
    (128, 512 * 28 * 28, torch.bfloat16, (8, 16, 264, 17)),
    (256, 512 * 14 * 14, torch.bfloat16, (8, 16, 132, 12)),
    (512, 512 * 7 * 7, torch.bfloat16, (8, 16, 66, 9)),
    (64, 512 * 112 * 112, torch.float32, (4, 16, 264, 17)),
    (512, 8 * 7 * 7, torch.bfloat16, (8, 16, 7, 3)),
    (24, 5, torch.bfloat16, (8, 1, 1, 1)),
    (3, 100, torch.float32, (1, 1, 1, 1)),
]


@pytest.mark.parametrize("c,rows,dtype,want", IR50_PLANS)
def test_launch_plan(monkeypatch, c, rows, dtype, want):
    """16-byte loads where C allows them, at most 16 a CTA's column block,
    two CTAs an SM in all, no fewer than four rows a thread, the partials
    summed in groups of ⌈√row_blocks⌉."""
    monkeypatch.setattr(bn, "_sms", lambda device: 132)
    x = torch.empty((rows, c, 1, 1), dtype=dtype)
    assert bn._plan(x) == (rows, c, *want)


def test_plan_takes_scalar_loads_off_alignment(monkeypatch):
    monkeypatch.setattr(bn, "_sms", lambda device: 132)
    x = torch.empty(512 * 64 + 1, dtype=torch.bfloat16)[1:].view(512, 64, 1, 1)
    assert bn._plan(x)[2] == 1
    assert bn._plan(x.clone())[2] == 8


def test_kernel_checks_refuse_what_it_does_not_take():
    c = 8
    w, b, rm, rv = torch.ones(c), torch.zeros(c), torch.zeros(c), torch.ones(c)
    cl = torch.channels_last
    ok = torch.randn(2, c, 3, 3).contiguous(memory_format=cl)
    bn._check(ok, w, b, rm, rv)
    bn._check(ok.bfloat16(), w, b, rm, rv)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        bn._check(ok.half(), w, b, rm, rv)
    with pytest.raises(ValueError, match="channels_last"):
        bn._check(torch.randn(2, c, 3, 3), w, b, rm, rv)
    with pytest.raises(ValueError, match="weight must be"):
        bn._check(ok, w.bfloat16(), b, rm, rv)
    with pytest.raises(ValueError, match="running_var must be"):
        bn._check(ok, w, b, rm, torch.ones(c + 1))
    with pytest.raises(ValueError, match="needs bias"):
        bn._check(ok, w, None, rm, rv)
