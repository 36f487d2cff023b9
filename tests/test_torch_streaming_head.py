"""The streamed margin CE (``losses/arcface.py::streaming_margin_ce``),
taken through ``Trainer._loss`` on its streaming path, against the
benchmark's plain reference (``benchmark/reference/arcface.py::arcface_ce``:
float32 torch, no JAX, nothing of the port) on seeded embeddings and W: the
loss and the gradients of the embeddings and of W, each at rtol 1e-5 (and
an atol of 1e-5 of the tensor's largest entry, as an entry of W's gradient
near 0 is a difference of near-equal terms and keeps their rounding). The
cases: a partial last block, every label inside the last block, padding
classes masked by ``num_valid``, and a block of 1 against a block of C."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)

import pytest
import torch

from benchmark.reference.arcface import arcface_ce
from crfr_torch.configs import Config, DataCfg, LossCfg, MeshCfg, ModelCfg, TrainCfg
from crfr_torch.train.loop import Trainer

B, D, S, M = 24, 512, 64.0, 0.5
RTOL = 1e-5


def trainer(classes: int, block: int) -> Trainer:
    cfg = Config(
        name="streamed-head", mesh=MeshCfg(data=1, model=1),
        data=DataCfg(image_size=32, num_classes=classes, degrade_min=16, degrade_max=32),
        model=ModelCfg(backbone="ir_18", compute_dtype="float32", dropout=0.0, input_size=32,
                       embedding_dim=D),
        loss=LossCfg(scale=S, margin=M, ce_block=block, ce_streaming_threshold=1),
        train=TrainCfg(batch_size=B, lr=0.1, warmup_steps=0, log_every=10, seed=0))
    tr = Trainer(cfg, steps_per_epoch=100, device="cpu")
    assert tr._ce_impl == "streaming"
    return tr


def inputs(classes: int, labels_from: int = 0, labels_to: int | None = None, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    emb = torch.randn(B, D, generator=g)
    w = torch.randn(D, classes, generator=g) * 0.05
    labels = torch.randint(labels_from, labels_to or classes, (B,), generator=g)
    return emb, w, labels


def program(emb, w, labels, block: int, num_valid: int | None = None):
    """Loss and gradients through ``Trainer._loss`` on the streaming path."""
    tr = trainer(w.shape[1], block)
    head = tr.model.head
    with torch.no_grad():
        head.weight.copy_(w)
    head.num_valid = num_valid
    e = emb.clone().requires_grad_(True)
    loss = tr._loss(e, labels)
    loss.backward()
    return loss.detach(), e.grad, head.weight.grad


def reference(emb, w, labels, valid: int):
    e = emb.clone().requires_grad_(True)
    wv = w[:, :valid].clone().requires_grad_(True)
    loss = arcface_ce(e, wv, labels, s=S, m=M)
    ge, gw = torch.autograd.grad(loss, [e, wv])
    return loss.detach(), ge, torch.cat([gw, torch.zeros_like(w[:, valid:])], 1)


def assert_equal(got, want):
    for name, a, b in zip(("loss", "emb grad", "W grad"), got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=RTOL * float(b.abs().max()),
                                   msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.parametrize("classes,block,labels", [
    (37, 8, (0, None)),          # a partial last block of 5
    (37, 8, (32, 37)),           # every label in that last block
    (64, 16, (0, None)),         # whole blocks
])
def test_the_streamed_head_equals_the_reference(classes, block, labels):
    emb, w, y = inputs(classes, *labels)
    assert_equal(program(emb, w, y, block), reference(emb, w, y, classes))


def test_padding_classes_are_masked_by_num_valid():
    """40 columns of which the last 3 are padding: the loss is the 37 valid
    classes' and the padding's columns of W get no gradient."""
    emb, w, y = inputs(40, 0, 37)
    got = program(emb, w, y, 8, num_valid=37)
    assert_equal(got, reference(emb, w, y, 37))
    assert torch.count_nonzero(got[2][:, 37:]) == 0


def test_a_block_of_one_equals_a_block_of_all_classes():
    emb, w, y = inputs(37, seed=1)
    one, whole = program(emb, w, y, 1), program(emb, w, y, 37)
    assert_equal(one, whole)
    assert_equal(one, reference(emb, w, y, 37))
