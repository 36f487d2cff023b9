"""crfr_torch.models.mobilefacenet against crfr.models.mobilefacenet on the
CPU, in float32, with crfr's weights and randomized BN statistics carried
by ``params_from_jax``: eval and train-mode embeddings and the BN running
statistics after a train-mode forward within crfr's own bound (atol 2e-3,
rtol 1e-3, tests/test_mobileface_bins.py:116; what each reached is in the
assertion messages and stays orders of magnitude inside). The factory, the
dtype policy, the int8 quantization leaving the grouped convs float, and
the bench pipeline on the CPU.
"""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from crfr.models.mobilefacenet import MobileFaceNet as RefMobileFaceNet
from crfr_torch.models.convert import params_from_jax
from crfr_torch.models.irse import build_backbone
from crfr_torch.models.mobilefacenet import MobileFaceNet
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-3, atol=2e-3)


def flat_state(jm) -> dict:
    flat = {}
    for state in nnx.state(jm, nnx.Param, nnx.BatchStat):
        for path, var in state.flat_state():
            flat["/".join(map(str, path))] = np.asarray(var[...])
    return flat


@pytest.fixture(scope="module")
def twins():
    rng = np.random.default_rng(0)
    jm = RefMobileFaceNet(embedding_dim=512, input_size=112, dtype=jnp.float32,
                          rngs=nnx.Rngs(0))
    for _, m in nnx.iter_graph(jm):
        if isinstance(m, nnx.BatchNorm):
            n = m.mean.value.shape[0]
            m.mean.value = jnp.asarray(rng.normal(0, 0.3, n), jnp.float32)
            m.var.value = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
    tm = MobileFaceNet(embedding_dim=512, input_size=112)
    tm.load_state_dict(params_from_jax(flat_state(jm)))
    return jm, tm


def test_state_carries_over(twins):
    _, tm = twins
    assert tm.blocks[0].depthwise.conv.groups == 128
    assert tm.blocks[0].depthwise.conv.weight.shape == (128, 1, 3, 3)
    assert tm.gdconv.weight.shape == (512, 1, 7, 7) and tm.out_linear.bias is None


def test_eval_forward_matches_crfr(twins, rng):
    jm, tm = twins
    x = rng.normal(0, 1, (2, 112, 112, 3)).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got - want).max() < 1e-4, np.abs(got - want).max()


def test_train_forward_and_statistics_match_crfr(rng):
    jm = RefMobileFaceNet(embedding_dim=128, input_size=32, dtype=jnp.float32,
                          rngs=nnx.Rngs(1))
    tm = MobileFaceNet(embedding_dim=128, input_size=32)
    tm.load_state_dict(params_from_jax(flat_state(jm)))
    x = rng.normal(0, 1, (6, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x), train=True))
    got = tm.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    after = params_from_jax(flat_state(jm))
    stats = {k: v for k, v in tm.state_dict().items() if "running_" in k}
    assert len(stats) == 2 * (2 + 3 * 15 + 3)        # every BN: stems, blocks, head, gd, out
    worst = max(float((stats[k] - after[k]).abs().max()) for k in stats)
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), after[k].numpy(), **TOL, err_msg=k)
    assert worst < 1e-4, worst


def test_factory_and_dtype_policy():
    m = build_backbone("mobilefacenet", dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0))
    assert isinstance(m, MobileFaceNet)
    assert m.stem.conv.weight.dtype == torch.bfloat16
    assert m.out_bn.weight.dtype == torch.float32
    assert m.stem.conv.weight.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        out = m.eval()(torch.zeros(2, 112, 112, 3))
    assert out.shape == (2, 512) and out.dtype == torch.float32
    again = build_backbone("mobilefacenet", generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.stem.conv.weight.to(torch.bfloat16), m.stem.conv.weight)
    with pytest.raises(ValueError, match="divisible by 16"):
        MobileFaceNet(input_size=100)


def test_quantize_leaves_grouped_convs_float(rng):
    from crfr_torch.models.quant import QuantConv, quantizable_convs, quantize_backbone

    m = build_backbone("mobilefacenet", input_size=32).eval()
    dense = quantizable_convs(m)
    grouped = [n for n, c in m.named_modules() if isinstance(c, torch.nn.Conv2d) and c.groups > 1]
    assert len(dense) == 1 + 3 * 15 - 15 + 1 and len(grouped) == 1 + 15 + 1
    x = torch.from_numpy(rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32))
    q = quantize_backbone(m, [x])
    kinds = {n: type(c) for n, c in q.named_modules()}
    assert all(kinds[n] is QuantConv for n, _ in dense)
    assert all(kinds[n] is torch.nn.Conv2d for n in grouped)
    with torch.no_grad():
        f, g = m(x), q(x)
    cos = torch.nn.functional.cosine_similarity(f, g).min().item()
    assert cos > 0.9, cos


def test_embed_pipeline_on_cpu():
    from crfr_torch.bench.throughput import build_embed_pipeline

    embed = build_embed_pipeline("mobilefacenet", degrade_to=8, image_size=32,
                                 dtype=torch.float32, device="cpu")
    x = torch.randint(0, 256, (3, 32, 32, 3), dtype=torch.uint8)
    out = embed(x)
    assert isinstance(embed.model, MobileFaceNet)
    assert out.shape == (3, 512) and torch.isfinite(out).all()
