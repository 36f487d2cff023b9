"""crfr_torch.models.quant against crfr/models/quant.py on the CPU.

``QuantConv`` on the same float conv and absmax (3×3 s1 p1 with bias, 3×3
s2 p1, 1×1 s2 'SAME', the 3-channel input conv with K = 27), its input
drawn as integer codes × sx so no code sits at a rounding tie: ``w8`` and
``sw`` equal, the s32 sums equal, the outputs within 1e-6 relative.
``calibrate``'s absmax per conv within 1e-5 relative, mapped by module
path. crfr's quantized IR-18 loaded through ``quant_state_from_jax``:
embeddings within cosine 0.999 a row (crfr's bound between two int8 runs,
tests/test_quant.py). The port's own int8 IR-18 against its float one:
cosine 0.995 (tests/test_quant.py:57). Grouped and depthwise convs stay
float. The operand padding that ``torch._int_mm`` needs on CUDA (M ≤ 16,
K = 27, N off 8) against the plain product. ``build_embed_pipeline(int8=True)``
against crfr's at 32 px with crfr's weights: cosine 0.99 (the bf16 degrade
operators differ, ROADMAP.md §3). The product on CPU tensors is the plain
int32 matmul; the tests run on one thread.
"""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import re

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp
from flax import nnx
from jax import lax

from crfr.models import quant as ref
from crfr_torch.models import quant
from crfr_torch.models.convert import params_from_jax, quant_state_from_jax
from tests.test_torch_irse import flat_state, jax_backbone, torch_twin
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)

SIZE = 32


def _cos(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _torch_conv(jc: nnx.Conv, stride: int, padding: int) -> nn.Conv2d:
    k = np.asarray(jc.kernel[...])                                    # HWIO
    tc = nn.Conv2d(k.shape[2], k.shape[3], k.shape[:2], stride, padding,
                   bias=jc.use_bias)
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
        if jc.use_bias:
            tc.bias.copy_(torch.from_numpy(np.array(jc.bias[...])))
    return tc


CONVS = {  # name: (cin, cout, kernel, stride, crfr padding, torch padding, bias)
    "3x3_s1_bias": (16, 32, 3, 1, 1, 1, True),
    "3x3_s2": (16, 16, 3, 2, 1, 1, False),
    "1x1_s2_same": (16, 32, 1, 2, "SAME", 0, False),
    "input_k27": (3, 64, 3, 1, 1, 1, False),
}


@pytest.mark.parametrize("case", list(CONVS))
def test_quantconv_equals_crfr(case):
    cin, cout, k, stride, jpad, tpad, bias = CONVS[case]
    jc = nnx.Conv(cin, cout, (k, k), strides=stride, padding=jpad, use_bias=bias,
                  rngs=nnx.Rngs(3))
    if bias:
        jc.bias.value = jnp.asarray(np.random.default_rng(4).normal(0, 0.1, cout), jnp.float32)
    absmax = 2.7
    jq = ref.QuantConv(jc, absmax)
    tq = quant.QuantConv(_torch_conv(jc, stride, tpad), absmax)

    np.testing.assert_array_equal(tq.w8.numpy(), np.asarray(jq.w8[...]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tq.sw.numpy(), np.asarray(jq.sw[...]))
    assert tq.sx.item() == float(jq.sx[...])

    sx = np.float32(jq.sx[...])
    codes = np.random.default_rng(5).integers(-127, 128, (2, 12, 12, cin))
    x = (codes * sx).astype(np.float32)                               # NHWC, no ties
    xq = jnp.clip(jnp.round(jnp.asarray(x) / sx), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(np.asarray(xq), codes)
    want_sums = np.asarray(lax.conv_general_dilated(
        xq, jq.w8[...], jq._strides, jq._padding, rhs_dilation=jq._dilation,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    sums, (b, ho, wo) = tq.int_sums(xt)
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.reshape(b, ho, wo, cout).numpy(), want_sums)

    want = np.asarray(jq(jnp.asarray(x)))
    got = tq(xt)
    assert got.dtype == torch.float32 and got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _crfr_path(path: str) -> str:
    return re.sub(r"\[(\d+)\]", r".\1", path)


@pytest.fixture(scope="module")
def calib():
    rng = np.random.default_rng(6)
    return [rng.normal(0, 0.7, (4, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def crfr_quantized(calib):
    """crfr's float32 IR-18 (random BN statistics) and its quantized twin,
    built once: XLA:CPU s8 convolutions are slow."""
    jm = jax_backbone()
    return jm, ref.quantize_backbone(jm, calib)


def test_calibrate_equals_crfr(crfr_quantized, calib):
    jm, _ = crfr_quantized
    want = {_crfr_path(p): v for p, v in ref.calibrate(nnx.clone(jm), calib).items()}
    tm = torch_twin(jm)
    got = quant.calibrate(tm, calib)
    assert set(got) == set(want) and len(got) == 1 + 2 * 8 + 4       # input, 2 a block, 4 shortcuts
    for name, v in want.items():
        assert got[name] == pytest.approx(v, rel=1e-5), name
    assert not tm.training and all(not m._forward_pre_hooks for m in tm.modules())


def _flat_quantized(jq) -> dict:
    """crfr's quantized backbone as '/'-joined paths: parameters, BN
    statistics and each QuantConv's w8, sw, sx (and bias)."""
    flat = flat_state(jq)
    for path, node in nnx.iter_graph(jq):
        if isinstance(node, ref.QuantConv):
            prefix = "/".join(map(str, path))
            for leaf in ("w8", "sw", "sx", "bias"):
                var = getattr(node, leaf)
                if var is not None:
                    flat[f"{prefix}/{leaf}"] = np.asarray(var[...])
    return flat


def test_crfr_quantized_backbone_carries_across(crfr_quantized, calib):
    jm, jq = crfr_quantized
    flat = _flat_quantized(jq)
    sd = quant_state_from_jax(flat)
    tq = quant.quantize_backbone(torch_twin(jm), calib)
    assert set(sd) == set(tq.state_dict())
    tq.load_state_dict(sd)
    assert sum(isinstance(m, quant.QuantConv) for m in tq.modules()) == 21
    for name, m in tq.named_modules():
        if isinstance(m, quant.QuantConv):
            want = np.asarray(flat[f"{name.replace('.', '/')}/w8"]).transpose(3, 2, 0, 1)
            np.testing.assert_array_equal(m.wmat[:, :want[0].size].numpy(),
                                          want.transpose(0, 2, 3, 1).reshape(len(want), -1))
    x = np.random.default_rng(7).normal(0, 0.7, (4, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jq(jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tq(torch.from_numpy(x)).numpy()
    cos = _cos(got, want)
    assert cos.min() > 0.999, cos


def test_converter_rejects_unknown_quant_leaves():
    with pytest.raises(KeyError, match="no counterpart"):
        quant_state_from_jax({"input_conv/w8": np.zeros((3, 3, 3, 8), np.int8),
                              "input_conv/zp": np.zeros(1)})


def test_quantized_embed_fn_fidelity(calib):
    """The port's int8 IR-18 against its float one (crfr's own bound)."""
    from crfr_torch.models.irse import build_backbone

    bb = build_backbone("ir_18", input_size=SIZE, dropout=0.0,
                        generator=torch.Generator().manual_seed(0)).eval()
    f = quant.quantized_embed_fn(bb, calib)
    x = np.random.default_rng(8).normal(0, 0.7, (4, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        ef = bb(torch.from_numpy(x)).numpy()
    eq = f(x)
    assert eq.dtype == torch.float32 and tuple(eq.shape) == (4, 512)
    assert bb.input_conv.__class__ is nn.Conv2d                       # the original stays float
    cos = _cos(eq.numpy(), ef)
    assert cos.min() > 0.995, cos


def test_compute_dtype_quantizes_float32_weights(calib):
    """``compute_dtype=bf16``: the convs quantize from the float32 weights,
    the scales stay float32, the model computes and the convs emit bf16;
    under autocast a float32 quantized model's convs emit the autocast
    dtype."""
    from crfr_torch.models.irse import build_backbone

    bb = build_backbone("ir_18", input_size=SIZE, generator=torch.Generator().manual_seed(0))
    q16 = quant.quantize_backbone(bb, calib, compute_dtype=torch.bfloat16)
    q32 = quant.quantize_backbone(bb, calib)
    for (n, a), (_, b) in zip(q16.named_modules(), q32.named_modules()):
        if isinstance(a, quant.QuantConv):
            assert torch.equal(a.w8, b.w8) and torch.equal(a.sw, b.sw), n
            assert a.sw.dtype == a.sx.dtype == torch.float32 and a.out_dtype == torch.bfloat16
    assert q16.out_linear.weight.dtype == torch.bfloat16
    assert q16.out_feat_bn.weight.dtype == torch.float32
    x = torch.from_numpy(calib[0])
    with torch.no_grad():
        assert q16.input_conv(torch.zeros(1, 3, 4, 4, dtype=torch.bfloat16)).dtype \
            == torch.bfloat16
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert q32.input_conv(torch.zeros(1, 3, 4, 4)).dtype == torch.bfloat16
        assert q32.input_conv(torch.zeros(1, 3, 4, 4)).dtype == torch.float32
        cos = _cos(q16(x).float().numpy(), q32(x).numpy())
    assert cos.min() > 0.99, cos


class _Grouped(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 16, 3, 1, 1)
        self.dw = nn.Conv2d(16, 16, 3, 1, 1, groups=16, bias=False)
        self.grouped = nn.Conv2d(16, 16, 3, 2, 1, groups=4, bias=False)
        self.pw = nn.Conv2d(16, 8, 1, bias=False)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.pw(self.grouped(self.dw(torch.relu(self.conv(x))))).mean(dim=(2, 3))


def test_grouped_and_depthwise_convs_stay_float():
    torch.manual_seed(0)
    m = _Grouped()
    x = torch.randn(2, 8, 8, 3)
    q = quant.quantize_backbone(m, [x])
    assert isinstance(q.conv, quant.QuantConv) and isinstance(q.pw, quant.QuantConv)
    assert type(q.dw) is nn.Conv2d and type(q.grouped) is nn.Conv2d
    assert type(m.conv) is nn.Conv2d                                  # a copy was quantized
    with torch.no_grad():
        cos = _cos(q(x).numpy(), m(x).numpy())
    assert cos.min() > 0.99, cos
    with pytest.raises(ValueError, match="stays float"):
        quant.QuantConv(m.dw, 1.0)


def test_calibrate_refuses_as_crfr():
    with pytest.raises(ValueError, match="no quantizable convs"):
        quant.calibrate(nn.Sequential(nn.Linear(4, 4)), [np.zeros((1, 4), np.float32)])
    with pytest.raises(ValueError, match="at least one batch"):
        quant.calibrate(_Grouped(), [])


@pytest.mark.parametrize("m,k,n", [(8, 27, 64), (1, 32, 60), (16, 8, 8), (40, 576, 64)])
def test_int_mm_operand_padding(m, k, n):
    """The operands ``int8_matmul`` hands ``torch._int_mm`` on CUDA: more
    than 16 rows, K and N multiples of 8, zeros in the padding; the product
    (``torch._int_mm`` runs on CPU tensors too) cut back equals the plain
    one."""
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    ap, bp = quant.int_mm_operands(a, b)
    assert ap.shape[0] > 16 and ap.shape[1] % 8 == 0 and bp.shape[0] % 8 == 0
    assert ap.shape[1] == bp.shape[1] and ap.is_contiguous() and bp.is_contiguous()
    assert not ap[m:].any() and not ap[:, k:].any() and not bp[n:].any()
    want = quant.int8_matmul_reference(a, b)
    assert torch.equal(torch._int_mm(ap, bp.t())[:m, :n], want)
    assert torch.equal(want, (a.double() @ b.double().t()).to(torch.int32))


def test_tiny_input_conv_sums_are_exact():
    """The input conv (K = 27 gathered into 32 columns) on one 3×3 image
    (M = 9 rows): the sums equal a float64 convolution of the codes."""
    torch.manual_seed(1)
    conv = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
    q = quant.QuantConv(conv, 1.0)
    assert tuple(q.wmat.shape) == (64, 32) and not q.wmat[:, 27:].any()
    x = torch.randn(1, 3, 3, 3).contiguous(memory_format=torch.channels_last)
    sums, shape = q.int_sums(x)
    codes = torch.round(x / q.sx).clamp(-127, 127)
    want = torch.nn.functional.conv2d(codes.double(), q.w8.double(), padding=1)
    assert shape == (1, 3, 3)
    assert torch.equal(sums.reshape(1, 3, 3, 64).permute(0, 3, 1, 2).double(), want)


def test_embed_pipeline_int8_equals_crfr(monkeypatch):
    """``build_embed_pipeline(int8=True)`` at 32 px, degrade 8, with crfr's
    seed-0 IR-18 weights, against crfr's int8 pipeline: calibration on the
    same two batches of degraded noise, one kernel-1 call a batch."""
    from crfr.bench.throughput import build_embed_pipeline as ref_pipeline
    from crfr.models.irse import build_backbone as ref_build
    from crfr_torch.bench import throughput
    from crfr_torch.ops import fused_preprocess as fp

    jm = ref_build("ir_18", input_size=SIZE, rngs=nnx.Rngs(0), dtype=jnp.bfloat16)
    sd = params_from_jax(flat_state(jm))
    built = []

    def crfr_weights(name, **kw):
        from crfr_torch.models.irse import build_backbone

        m = build_backbone(name, **kw)
        m.load_state_dict(sd)
        built.append(kw["dtype"])
        return m

    monkeypatch.setattr(throughput, "build_backbone", crfr_weights)
    got_fn = throughput.build_embed_pipeline("ir_18", degrade_to=8, image_size=SIZE,
                                             int8=True, device="cpu")
    assert built == [torch.float32]                       # quantized from float32 weights
    want_fn = ref_pipeline("ir_18", degrade_to=8, image_size=SIZE, int8=True)
    x = np.random.default_rng(9).integers(0, 256, (8, SIZE, SIZE, 3)).astype(np.uint8)
    calls = []
    monkeypatch.setattr(fp, "fused_degrade_normalize_reference",
                        lambda *a, _f=fp.fused_degrade_normalize_reference, **k:
                        calls.append(1) or _f(*a, **k))
    got = got_fn(torch.from_numpy(x))
    assert calls == [1] and got.dtype == torch.float32 and tuple(got.shape) == (8, 512)
    cos = _cos(got.numpy(), np.asarray(want_fn(jnp.asarray(x))))
    assert cos.min() > 0.99, cos


def test_ir50_has_the_17_conv_shapes_the_card_tests_take():
    """``quantizable_convs`` of IR-50, their inputs read on one forward at
    112²: 53 convs of the 17 distinct shapes that
    tests/test_torch_kernels_gpu.py checks on the card."""
    from crfr_torch.models.irse import build_backbone
    from tests.test_torch_kernels_gpu import IR50_CONVS

    m = build_backbone("ir_50", generator=torch.Generator().manual_seed(0)).eval()
    seen = []
    for _, c in quant.quantizable_convs(m):
        c.register_forward_pre_hook(lambda mod, args: seen.append((mod, args[0].shape[2])))
    with torch.no_grad():
        m(torch.zeros(1, 112, 112, 3))
    assert len(seen) == 53
    shapes = {(c.in_channels, c.out_channels, c.kernel_size[0], c.stride[0], side)
              for c, side in seen}
    assert shapes == set(IR50_CONVS) and len(IR50_CONVS) == 17


def test_profiler_ranges_group_the_conv_kernels():
    """``QuantConv`` opens its four profiler ranges while a profiler runs
    (none otherwise), and ``bench.xprof_check`` gives a kernel the group of
    the range its launch lies in."""
    from torch.profiler import ProfilerActivity, profile

    from crfr_torch.bench import xprof_check as xc

    q = quant.QuantConv(nn.Conv2d(8, 16, 3, 1, 1), 1.0)
    x = torch.randn(1, 8, 6, 6).contiguous(memory_format=torch.channels_last)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        q(x)
    names = {e.name for e in prof.events()}
    assert set(xc._QUANT_SPANS) <= names
    events = [{"cat": "user_annotation", "name": "quant::gather", "ts": 10, "dur": 5},
              {"cat": "user_annotation", "name": "quant::int_mm", "ts": 20, "dur": 5},
              {"cat": "cuda_runtime", "name": "launch", "ts": 12, "args": {"correlation": 1}},
              {"cat": "cuda_runtime", "name": "launch", "ts": 22, "args": {"correlation": 2}},
              {"cat": "cuda_runtime", "name": "launch", "ts": 30, "args": {"correlation": 3}}]
    kernels = [{"name": "copy", "args": {"correlation": c}} for c in (1, 2, 3, 4)]
    assert xc._span_groups(events, kernels, xc._QUANT_SPANS) == \
        ["patch_gather", "int_mm", None, None]


def test_run_throughput_int8_reports_as_bf16():
    """``run_throughput(int8=True)`` gives the bf16 path's ``BenchResult``
    (tiny, on the CPU: only the fields and the call count are checked)."""
    from crfr_torch.bench.throughput import BenchResult, run_throughput

    r = run_throughput(batch=2, steps=1, repeats=1, backbone="ir_18", degrade_to=8,
                       image_size=SIZE, int8=True, device="cpu")
    assert isinstance(r, BenchResult) and r.device == "cpu"
    assert (r.batch, r.steps) == (2, 1) and r.imgs_per_sec > 0
    assert r.per_batch_ms == pytest.approx(1e3 * 2 / r.imgs_per_sec)
