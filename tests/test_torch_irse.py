"""crfr_torch.models.irse against crfr.models.irse on the CPU, in float32,
with the weights carried across by crfr_torch.models.convert.params_from_jax
and the BN statistics randomised so eval-mode normalisation is exercised.
Tolerance as tests/test_irse_parity.py: atol 2e-3, rtol 1e-3."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from crfr.models.irse import IRBackbone as JaxIR
from crfr_torch.models.convert import params_from_jax
from crfr_torch.models.irse import IRBackbone, build_backbone


def jax_backbone(depth="18", use_se=False, input_size=32, seed=3):
    """A float32 JAX IRBackbone with random BN statistics."""
    jm = JaxIR(depth=depth, use_se=use_se, dtype=jnp.float32,
               input_size=input_size, rngs=nnx.Rngs(seed))
    rng = np.random.default_rng(seed + 4)
    for _, m in nnx.iter_graph(jm):
        if isinstance(m, nnx.BatchNorm):
            n = m.mean.value.shape[0]
            m.mean.value = jnp.asarray(rng.normal(0, 0.5, n), jnp.float32)
            m.var.value = jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32)
            m.scale.value = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
            m.bias.value = jnp.asarray(rng.normal(0, 0.2, n), jnp.float32)
    return jm


def flat_state(jm) -> dict:
    """Parameters and BN statistics keyed by their '/'-joined nnx paths."""
    flat = {}
    for state in nnx.state(jm, nnx.Param, nnx.BatchStat):
        for path, var in state.flat_state():
            flat["/".join(map(str, path))] = np.asarray(var.value)
    return flat


def torch_twin(jm, depth="18", use_se=False, input_size=32) -> IRBackbone:
    tm = IRBackbone(depth=depth, use_se=use_se, input_size=input_size)
    tm.load_state_dict(params_from_jax(flat_state(jm)))
    return tm.eval()


@pytest.mark.parametrize("use_se", [False, True])
def test_ir18_matches_jax(use_se):
    jm = jax_backbone(use_se=use_se)
    tm = torch_twin(jm, use_se=use_se)
    x = np.random.default_rng(11).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-3)

    jf = jm.features(jnp.asarray(x), train=False)
    with torch.no_grad():
        tf = tm.features(torch.from_numpy(x))
    assert len(tf) == len(jf) == 4
    for a, b in zip(jf, tf):
        assert tuple(b.shape) == a.shape                 # NHWC taps
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-3, rtol=1e-3)


def test_converter_covers_every_tensor():
    jm = jax_backbone(use_se=True)
    sd = params_from_jax(flat_state(jm))
    tm = IRBackbone(depth="18", use_se=True, input_size=32)
    assert set(sd) == set(tm.state_dict())


def test_converter_rejects_unknown_leaves():
    with pytest.raises(KeyError, match="no counterpart"):
        params_from_jax({"blocks/0/conv1/rngs": np.zeros(1)})


def test_ir50_shapes():
    tm = build_backbone("ir_50").eval()
    with torch.no_grad():
        out = tm(torch.zeros(1, 112, 112, 3))
    assert out.shape == (1, 512) and out.dtype == torch.float32
    assert len(tm.blocks) == 24


def test_bf16_backbone_keeps_bn1d_in_float32():
    tm = build_backbone("ir_18", input_size=32, dtype=torch.bfloat16).eval()
    assert tm.input_conv.weight.dtype == torch.bfloat16
    assert tm.out_feat_bn.weight.dtype == torch.float32
    ref = build_backbone("ir_18", input_size=32).eval()
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        got, want = tm(x), ref(x)
    assert got.dtype == torch.float32
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert cos.min() > 0.99, cos


@pytest.mark.parametrize("name,blocks,se", [("ir_se_101", 49, True), ("IR_34", 16, False)])
def test_build_backbone_names(name, blocks, se):
    tm = build_backbone(name, input_size=16)
    assert len(tm.blocks) == blocks
    assert (tm.blocks[0].se is not None) == se


def test_build_backbone_refuses_unported_and_unknown():
    with pytest.raises(NotImplementedError, match="not ported"):
        build_backbone("mobilefacenet")
    with pytest.raises(ValueError, match="unknown backbone"):
        build_backbone("resnet_50")


def test_generator_makes_weights_reproducible():
    a = build_backbone("ir_18", input_size=16, generator=torch.Generator().manual_seed(5))
    b = build_backbone("ir_18", input_size=16, generator=torch.Generator().manual_seed(5))
    c = build_backbone("ir_18", input_size=16, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a.blocks[3].conv2.weight, b.blocks[3].conv2.weight)
    assert not torch.equal(a.blocks[3].conv2.weight, c.blocks[3].conv2.weight)
