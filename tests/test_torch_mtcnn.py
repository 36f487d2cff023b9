"""crfr_torch.models.mtcnn against crfr.models.mtcnn on the CPU.

The nets with crfr's weights (``mtcnn_state_from_jax``): outputs within
1e-5 at odd pyramid sizes (float32 convolutions in another order). The
host machinery (NMS, decode, regression, squaring): equal. ``crop_resize``:
the port resizes each zero-padded crop and normalizes in float32 (the
kernel's plain version on the CPU), crfr in float64 on the host through its
C++ library, then normalizes: within 2e-5 in normalized units (2.6e-3 of a
pixel level). ``load_torch_weights``: the same function from one
state_dict (outputs within 1e-5 relative). The cascade at thresholds (0.3, 0, 0), as tests/test_mtcnn.py
runs crfr's: the same detections, boxes and landmarks within 1e-3 px,
scores within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from crfr.models import mtcnn as rm
from crfr_torch.models import mtcnn as pm
from crfr_torch.models.convert import mtcnn_state_from_jax
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)


def jax_flat(det) -> dict:
    out = {}
    for name in ("pnet", "rnet", "onet"):
        for path, var in nnx.state(getattr(det, name), nnx.Param).flat_state():
            out["/".join([name, *map(str, path)])] = np.asarray(var[...])
    return out


@pytest.fixture(scope="module")
def twins():
    ref = rm.MTCNN(min_face=40, thresholds=(0.3, 0.0, 0.0), seed=0)
    port = pm.MTCNN(min_face=40, thresholds=(0.3, 0.0, 0.0), seed=5, device="cpu")
    port.load_state_dict(mtcnn_state_from_jax(jax_flat(ref)))
    return ref, port


@pytest.mark.parametrize("hw", [(12, 12), (37, 29), (101, 77), (24, 13)])
def test_pnet_matches_crfr_at_odd_sizes(twins, hw, rng):
    ref, port = twins
    x = rng.normal(0, 1, (2, *hw, 3)).astype(np.float32)
    pj, rj = ref.pnet(jnp.asarray(x))
    with torch.no_grad():
        pp, rp = port.pnet(torch.from_numpy(x))
    assert pp.shape == pj.shape and rp.shape == rj.shape
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("net,size", [("rnet", 24), ("onet", 48)])
def test_r_and_o_net_match_crfr(twins, net, size, rng):
    ref, port = twins
    x = rng.normal(0, 1, (5, size, size, 3)).astype(np.float32)
    want = getattr(ref, net)(jnp.asarray(x))
    with torch.no_grad():
        got = getattr(port, net)(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("size,stride", [(2, 2), (3, 2)])
@pytest.mark.parametrize("hw", [(5, 5), (6, 7), (10, 11), (23, 22)])
def test_max_pool_ceil_mode_matches_crfrs_padding(hw, size, stride, rng):
    x = rng.normal(0, 1, (2, *hw, 4)).astype(np.float32)
    want = np.asarray(rm._MaxPool(size, stride)(jnp.asarray(x)))
    got = pm._MaxPool(size, stride)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_host_machinery_equals_crfrs(rng):
    boxes = np.sort(rng.uniform(0, 200, (40, 4)).astype(np.float32).reshape(40, 2, 2),
                    axis=1).reshape(40, 4)[:, [0, 2, 1, 3]]
    scores = rng.uniform(0, 1, 40).astype(np.float32)
    for t in (0.3, 0.5, 0.7):
        for method in ("union", "min"):
            assert np.array_equal(pm.nms(boxes, scores, t, method), rm.nms(boxes, scores, t, method))
    assert pm.nms(boxes[:0], scores[:0], 0.5).shape == (0,)
    prob = rng.uniform(0, 1, (23, 17)).astype(np.float32)
    reg = rng.normal(0, 0.1, (23, 17, 4)).astype(np.float32)
    for scale in (0.6, 0.3012, 0.1):
        a, b = pm.decode_pnet(prob, reg, scale, 0.7), rm.decode_pnet(prob, reg, scale, 0.7)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    b9 = np.concatenate([boxes, scores[:, None], rng.normal(0, 0.1, (40, 4))], 1)
    b9 = b9.astype(np.float32)
    assert np.array_equal(pm.apply_regression(b9), rm.apply_regression(b9))
    assert np.array_equal(pm.square_boxes(b9), rm.square_boxes(b9))
    mt, ref = pm.MTCNN(min_face=20, device="cpu"), rm.MTCNN(min_face=20)
    assert mt._pyramid_scales(480, 640) == ref._pyramid_scales(480, 640)


def test_crop_resize_matches_crfrs(rng):
    img = rng.integers(0, 256, (90, 70, 3)).astype(np.uint8)
    boxes = np.asarray([[10.7, 5.2, 40.9, 35.1], [-8.6, -3.2, 30.1, 36.4],
                        [50.0, 60.0, 95.0, 105.0], [20.0, 20.0, 20.0, 30.0],
                        [-50.0, -40.0, -10.0, -1.0], [0.0, 0.0, 70.0, 90.0]], np.float32)
    for size in (24, 48):
        want = (rm.crop_resize(img.astype(np.float32), boxes, size) - 127.5) / 128.0
        got = pm.crop_resize(torch.from_numpy(img), boxes, size)
        assert got.dtype == torch.float32 and got.shape == (6, size, size, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
        assert (got[3] == -127.5 / 128.0).all() and (got[4] == -127.5 / 128.0).all()
    # a float image takes the float path, to the same values
    got_f = pm.crop_resize(torch.from_numpy(img.astype(np.float32)), boxes, 24)
    np.testing.assert_allclose(got_f.numpy(), pm.crop_resize(torch.from_numpy(img), boxes,
                                                             24).numpy(), rtol=0, atol=1e-6)


def _facenet_state(net: str, g: torch.Generator) -> dict:
    """A state_dict in facenet-pytorch's names and order."""
    shapes = {
        "pnet": [("conv1.weight", (10, 3, 3, 3)), ("conv1.bias", (10,)), ("prelu1.weight", (10,)),
                 ("conv2.weight", (16, 10, 3, 3)), ("conv2.bias", (16,)),
                 ("prelu2.weight", (16,)), ("conv3.weight", (32, 16, 3, 3)),
                 ("conv3.bias", (32,)), ("prelu3.weight", (32,)),
                 ("conv4_1.weight", (2, 32, 1, 1)), ("conv4_1.bias", (2,)),
                 ("conv4_2.weight", (4, 32, 1, 1)), ("conv4_2.bias", (4,))],
        "rnet": [("conv1.weight", (28, 3, 3, 3)), ("conv1.bias", (28,)), ("prelu1.weight", (28,)),
                 ("conv2.weight", (48, 28, 3, 3)), ("conv2.bias", (48,)),
                 ("prelu2.weight", (48,)), ("conv3.weight", (64, 48, 2, 2)),
                 ("conv3.bias", (64,)), ("prelu3.weight", (64,)),
                 ("dense4.weight", (128, 576)), ("dense4.bias", (128,)),
                 ("prelu4.weight", (128,)), ("dense5_1.weight", (2, 128)),
                 ("dense5_1.bias", (2,)), ("dense5_2.weight", (4, 128)),
                 ("dense5_2.bias", (4,))],
    }[net]
    return {k: torch.randn(s, generator=g) * 0.2 for k, s in shapes}


def test_load_torch_weights_matches_crfrs(rng):
    g = torch.Generator().manual_seed(0)
    sds = {"pnet_sd": _facenet_state("pnet", g), "rnet_sd": _facenet_state("rnet", g)}
    ref = rm.MTCNN()
    ref.load_torch_weights(**sds)
    port = pm.MTCNN(device="cpu")
    port.load_torch_weights(**sds)
    want = mtcnn_state_from_jax({k: v for k, v in jax_flat(ref).items()
                                 if not k.startswith("onet")})
    got = port.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    x = rng.normal(0, 1, (3, 24, 24, 3)).astype(np.float32)
    with torch.no_grad():
        pp, rp = port.rnet(torch.from_numpy(x))
    pj, rj = ref.rnet(jnp.asarray(x))
    # weights of std 0.2 give outputs of ~100: float32 to 1e-5 relative
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-5)
    bad = dict(sds["pnet_sd"])
    bad["conv1.weight"] = torch.zeros(10, 3, 2, 2)
    with pytest.raises(ValueError, match="shape"):
        port.load_torch_weights(pnet_sd=bad)


def test_state_from_jax_refuses_other_modules():
    with pytest.raises(KeyError, match="not under"):
        mtcnn_state_from_jax({"backbone/conv/kernel": np.zeros((3, 3, 3, 4), np.float32)})


def test_cascade_matches_crfr(twins, rng):
    ref, port = twins
    img = rng.integers(0, 256, (160, 120, 3)).astype(np.uint8)
    want = ref.detect(img)
    got = port.detect(img)
    assert len(want.boxes) > 5
    assert got.boxes.shape == want.boxes.shape and got.landmarks.shape == want.landmarks.shape
    np.testing.assert_allclose(got.boxes, want.boxes, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.landmarks, want.landmarks, rtol=0, atol=1e-3)


def test_cascade_without_candidates(twins):
    _, port = twins
    det = pm.MTCNN(min_face=40, thresholds=(1.01, 0.0, 0.0), device="cpu")
    out = det.detect(np.zeros((64, 64, 3), np.uint8))
    assert out.boxes.shape == (0, 4) and out.landmarks.shape == (0, 5, 2)
    assert port.detect(np.zeros((10, 10, 3), np.uint8)).boxes.shape == (0, 4)


def test_stages_called_one_by_one_equal_detect(twins, rng):
    """The stage methods outside ``detect`` (no inference mode around them)
    give detect's result."""
    _, port = twins
    img = rng.integers(0, 256, (120, 100, 3)).astype(np.uint8)
    x = pm.photo_tensor(img, port.device)
    staged = port.stage3(x, port.stage2(x, port.stage1(x)))
    whole = port.detect(img)
    assert np.array_equal(staged.boxes, whole.boxes)
    assert np.array_equal(staged.landmarks, whole.landmarks)
