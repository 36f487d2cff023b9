"""The serving artifact on the card: the custom ops of kernels 1 and 2 pass
``torch.library.opcheck`` on CUDA tensors and never take the plain
version; an artifact exported on the card (IR-18 at 32 px, float32, under
``strict_fp32``) launches kernel 1 once a call, or kernel 2 once behind a
hallucinator, from the op's CUDA body, and equals ``build_serving_fn``.

These tests need a CUDA device and skip without one. The file imports
neither JAX nor crfr:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serve_export_gpu.py
"""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import pytest
import torch

from crfr_torch.configs import get_config
from crfr_torch.device import strict_fp32
from crfr_torch.ops import fused_preprocess as fp
from crfr_torch.serve import build_serving_fn, export_embed, load_embed
from crfr_torch.train.loop import Trainer
from crfr_torch.train.sr_loop import SRTrainer

pytestmark = pytest.mark.gpu

OV = ["data.image_size=32", "model.input_size=32", "data.num_classes=4",
      "model.backbone=ir_18", "model.compute_dtype=float32", "model.dropout=0.0"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with strict_fp32():
        yield torch.device("cuda")


def _pixels(shape, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g, device=device).to(torch.uint8)


def _counts():
    return (fp.fused_degrade_normalize.launches, fp.fused_resize_normalize.launches)


@pytest.mark.parametrize("case", ["degrade", "resize"])
def test_custom_ops_opcheck_on_the_card(cuda, case):
    x = _pixels((3, 112, 112, 3), cuda)
    ops = torch.ops.crfr_torch
    if case == "degrade":
        torch.library.opcheck(ops.fused_degrade_normalize, (x, 16, "pil", torch.bfloat16))
    else:
        torch.library.opcheck(ops.fused_resize_normalize, (x, [14, 14], "pil", torch.float32))


def test_custom_ops_never_take_the_plain_version(cuda, monkeypatch):
    x = _pixels((2, 112, 112, 3), cuda)
    want = fp.fused_degrade_normalize_reference(x, 16, "pil", torch.float32)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("_reference", "fused_degrade_normalize_reference",
                 "fused_resize_normalize_reference"):
        monkeypatch.setattr(fp, name, refuse)
    before = _counts()
    got = torch.ops.crfr_torch.fused_degrade_normalize(x, 16, "pil", torch.float32)
    torch.ops.crfr_torch.fused_resize_normalize(x, [14, 14], "pil", torch.float32)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_artifact_launches_each_kernel_once_a_call(cuda, tmp_path):
    tr = Trainer(get_config("casia_arcface", OV), device="cuda")
    x = _pixels((8, 32, 32, 3), cuda, seed=1)
    export_embed(tr, str(tmp_path / "m.crfrt"), batch=8, degrade_to=16, flip_tta=True)
    sr = SRTrainer(tr.cfg, scale=4, n_priors=4, device="cuda")
    export_embed(tr, str(tmp_path / "sr.crfrt"), batch=8, degrade_to=8,
                 sr_apply=sr.sr_apply(ema=False))
    fn, fn_sr = load_embed(str(tmp_path / "m.crfrt")), load_embed(str(tmp_path / "sr.crfrt"))
    assert fn.meta["platforms"] == ["cuda"]

    before = _counts()
    got = fn(x)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1])
    live = build_serving_fn(lambda y: tr.backbone_apply(tr.model.backbone, y), degrade_to=16,
                            flip_tta=True, image_size=32, device="cuda")
    torch.testing.assert_close(got, live(x), atol=1e-4, rtol=1e-4)

    before = _counts()
    got_sr = fn_sr(x)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1] + 1)
    assert got_sr.device.type == "cuda" and torch.isfinite(got_sr).all()
    with pytest.raises(Exception, match="size"):
        fn(x[:4])
