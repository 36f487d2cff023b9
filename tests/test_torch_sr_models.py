"""crfr_torch.models.sr against crfr.models.sr on the CPU: the Hallucinator
in train and eval mode at scales 4, 7 and 14 with 4 and 16 priors, the
Discriminator, the sub-pixel shuffle and the converter's carrying of the
weights by nnx path, within 1e-5 (crfr's own tolerance for the coarse
path, tests/test_sr_recognition.py:93) of each output's scale: absolute
where an output stays within ±1, else relative to its largest magnitude
(G's trunk reaches ~100 with random heads, where float32's own spacing is
7.6e-6). BN running statistics after a train-mode call are held to the
train tests' rtol 2e-4 / atol 2e-5: flax takes the batch variance as
E[x²] − E[x]², torch in a two-pass form, and the two part by ~2e-5
relative in float32. And the port's own init, at which G equals bicubic
upsampling."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from crfr.models import sr as jsr
from crfr_torch.models import sr
from crfr_torch.models.convert import params_from_jax
from crfr_torch.ops.bicubic import resize_matrix
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)

def assert_close(got, want, err_msg: str = "") -> None:
    """Within 1e-5 of the output's scale: max(1, max |want|)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale, err_msg=err_msg)


def jax_flat(module) -> dict:
    return {"/".join(map(str, path)): np.asarray(var[...])
            for path, var in nnx.state(module).flat_state()}


def randomize_heads(jm, rng) -> None:
    """Give the zero-initialised correction heads random weights, so that
    every branch of G reaches the output."""
    for conv in (jm.coarse.out, jm.gen.out):
        conv.kernel.value = jnp.asarray(rng.normal(0, 0.05, conv.kernel.value.shape), jnp.float32)
        conv.bias.value = jnp.asarray(rng.normal(0, 0.05, conv.bias.value.shape), jnp.float32)


def twins(scale: int, n_priors: int, rng):
    jm = jsr.Hallucinator(scale=scale, n_priors=n_priors, rngs=nnx.Rngs(0))
    randomize_heads(jm, rng)
    tm = sr.Hallucinator(scale, n_priors)
    tm.load_state_dict(params_from_jax(jax_flat(jm)))
    return jm, tm


@pytest.mark.parametrize("scale,s_lr,n_priors", [(4, 8, 4), (4, 8, 16), (7, 8, 4),
                                                  (14, 4, 16)])
@pytest.mark.parametrize("train", [False, True])
def test_hallucinator_matches_crfr(scale, s_lr, n_priors, train):
    """sr, coarse and priors; in train mode also every BN's running
    statistics after the call. (The depth-3 hourglass needs an output size
    divisible by 8, so scale 7 runs at LR 8 and scale 14 at LR 4: 56 px.)"""
    rng = np.random.default_rng(scale * 100 + n_priors)
    jm, tm = twins(scale, n_priors, rng)
    x = rng.uniform(-1, 1, (3, s_lr, s_lr, 3)).astype(np.float32)
    want = jm(jnp.asarray(x), train=train)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for name, g, w in zip(("sr", "coarse", "priors"), got, want):
        assert g.shape == w.shape
        assert_close(g.numpy(), w, name)
    if train:
        stats = params_from_jax({k: v for k, v in jax_flat(jm).items()
                                 if k.endswith(("/mean", "/var"))})
        sd = tm.state_dict()
        for k, v in stats.items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_crfr(train):
    rng = np.random.default_rng(1)
    jd = jsr.Discriminator(rngs=nnx.Rngs(1))
    td = sr.Discriminator()
    flat = jax_flat(jd)
    assert "layers/0/conv/bias" in flat and "layers/1/bn/mean" in flat and "fc/kernel" in flat
    td.load_state_dict(params_from_jax(flat))
    x = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    want = jd(jnp.asarray(x), train=train)
    td.train(train)
    with torch.no_grad():
        got = td(torch.from_numpy(x))
    assert got.shape == (4,)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("r", [2, 7])
def test_depth_to_space_is_crfrs_order(r):
    """Bit-equal to the reference's shuffle, and not PixelShuffle's order."""
    x = np.random.default_rng(r).normal(size=(2, 3, 5, 4 * r * r)).astype(np.float32)
    got = sr._depth_to_space(torch.from_numpy(x), r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsr._depth_to_space(jnp.asarray(x), r)))
    shuffled = torch.nn.functional.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), r)
    assert not np.array_equal(got.numpy(), shuffled.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("scale,s_lr", [(4, 8), (7, 16), (14, 8)])
def test_port_init_is_bicubic(scale, s_lr):
    """The port's own init (seed 0, heads at zero): coarse and sr both equal
    bicubic↑ of the input, in train and eval mode, and the zero heads are
    the only zero conv weights."""
    g = sr.build_hallucinator(scale, n_priors=4)
    x = np.random.default_rng(2).uniform(-1, 1, (2, s_lr, s_lr, 3)).astype(np.float32)
    w = resize_matrix(s_lr, s_lr * scale, "pil")
    bic = np.einsum("oi,bijc,pj->bopc", w, x, w)
    for train in (False, True):
        g.train(train)
        with torch.no_grad():
            out, coarse, priors = g(torch.from_numpy(x))
        np.testing.assert_allclose(coarse.numpy(), bic, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(out.numpy(), coarse.numpy())
        assert priors.shape == (2, s_lr * scale, s_lr * scale, 4)
    zero = sorted(k for k, v in g.state_dict().items() if v.ndim == 4 and not v.any())
    assert zero == ["coarse.out.weight", "gen.out.weight"]
    assert not (g.coarse.out.bias.any() or g.gen.out.bias.any())


def test_seeded_init_is_deterministic():
    a, b = sr.build_hallucinator(4, 4), sr.build_hallucinator(4, 4)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    d0, d1 = sr.build_discriminator(), sr.build_discriminator(torch.Generator().manual_seed(0))
    assert not torch.equal(d0.fc.weight, d1.fc.weight)


def test_refuses_a_scale_below_two():
    with pytest.raises(ValueError, match="scale must be an integer >= 2"):
        sr.Hallucinator(scale=1)


def test_sr_modules_import_none_of_the_jax_stack():
    """The SR modules of the port import neither JAX nor crfr, nor optax."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import crfr_torch.models.sr, crfr_torch.ops.heatmaps, crfr_torch.losses.gan\n"
            "import crfr_torch.eval.image_quality, crfr_torch.train.sr_loop\n"
            "import crfr_torch.train.distill_loop, crfr_torch.cli\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'flax', 'crfr', 'optax', 'orbax'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
