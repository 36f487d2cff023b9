"""The serving artifact on the CPU: the custom ops of kernels 1 and 2
(``torch.library.opcheck``); ``export_embed`` → file → ``load_embed`` equal
to the live ``build_serving_fn`` bit for bit for the plain, degrade-16,
flip-TTA and int8 pipelines (IR-18 at 32 px, float32); the loaded artifact
against ``crfr``'s ``load_embed`` of the same weights within crfr's own
atol 1e-4 (tests/test_serve_misc.py); the hallucinated artifact at G's init
against the bicubic one within crfr's 1e-2; the graph (one node of the
custom op where the preprocessing is, none of the plain version's
products); the meta keys and the errors; ``serve_artifact`` against
``make_server``; and ``python -m crfr_torch export`` then ``serve-http
--artifact`` in a child process."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import io
import json
import os
import signal
import struct
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from crfr.configs import Config, DataCfg, LossCfg, MeshCfg, ModelCfg, TrainCfg
from crfr.serve import export_embed as ref_export_embed
from crfr.serve import load_embed as ref_load_embed
from crfr.train.loop import Trainer as RefTrainer
from crfr_torch.configs import Config as PortConfig
from crfr_torch.eval.bank import QuantBank, ServingBank, load_bank, quantize_bank, save_bank
from crfr_torch.models.convert import train_state_from_jax
from crfr_torch.models.quant import calibration_batch, quantize_backbone
from crfr_torch.ops import fused_preprocess as fp
from crfr_torch.serve import build_serving_fn, export_embed, load_embed, read_meta
from crfr_torch.serve_http import make_server, serve_artifact
from crfr_torch.train.loop import Trainer
from crfr_torch.train.sr_loop import SRTrainer
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)
from tests.test_torch_train import ref_flat

B, S = 4, 32


def tiny_cfg() -> Config:
    """crfr's export test config (tests/test_serve_misc.py)."""
    return Config(
        name="serve-test", mesh=MeshCfg(data=1, model=1),
        data=DataCfg(image_size=S, num_classes=4, degrade_min=16, degrade_max=S),
        model=ModelCfg(backbone="ir_18", compute_dtype="float32", dropout=0.0, input_size=S),
        loss=LossCfg(scale=16.0, margin=0.2), train=TrainCfg(batch_size=8, warmup_steps=2))


@pytest.fixture(scope="module")
def trainers():
    ref = RefTrainer(tiny_cfg(), steps_per_epoch=10)
    port = Trainer(PortConfig.from_dict(tiny_cfg().to_dict()), device="cpu")
    port.model.load_state_dict(train_state_from_jax(ref_flat(ref)))
    return ref, port


def _pixels(seed: int, n: int = B) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, S, S, 3)).astype(np.uint8)


def _live(tr, **kw):
    return build_serving_fn(lambda x: tr.backbone_apply(tr.model.backbone, x), image_size=S,
                            device="cpu", **kw)


def _int8(tr):
    calib = [calibration_batch(_pixels(9, 8), 16, "pil", "cpu")]
    return quantize_backbone(tr.model.backbone, calib, compute_dtype=tr.compute_dtype)


# ---- the custom ops --------------------------------------------------------

@pytest.mark.parametrize("case", ["u8_low16_pil_f32", "f32_low15_cv2_bf16", "resize_u8_f32",
                                  "resize_f32_bf16"])
def test_custom_ops_pass_opcheck(case):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (2, S, S, 3)).astype(np.uint8))
    ops = torch.ops.crfr_torch
    args = {"u8_low16_pil_f32": (ops.fused_degrade_normalize, (x, 16, "pil", torch.float32)),
            "f32_low15_cv2_bf16": (ops.fused_degrade_normalize,
                                   (x.float(), 15, "cv2", torch.bfloat16)),
            "resize_u8_f32": (ops.fused_resize_normalize, (x, [8, 12], "pil", torch.float32)),
            "resize_f32_bf16": (ops.fused_resize_normalize,
                                (x.float(), [16, 16], "cv2", torch.bfloat16))}[case]
    torch.library.opcheck(*args)
    out = args[0](*args[1])
    want = (fp.fused_degrade_normalize_reference(*args[1]) if "low" in case
            else fp.fused_resize_normalize_reference(args[1][0], tuple(args[1][1]),
                                                     *args[1][2:]))
    assert torch.equal(out, want) and out.is_contiguous()


# ---- export against the live function and against crfr ---------------------

@pytest.mark.parametrize("pipeline", ["plain", "degrade16", "flip_tta", "int8"])
def test_export_equals_live_bit_for_bit(trainers, tmp_path, pipeline):
    _, tr = trainers
    kw = {"plain": {}, "degrade16": {"degrade_to": 16}, "flip_tta": {"flip_tta": True},
          "int8": {"degrade_to": 16}}[pipeline]
    path = str(tmp_path / "m.crfrt")
    if pipeline == "int8":
        q = _int8(tr)
        meta = export_embed(tr, path, batch=B, backbone_apply=q, quantized=True, **kw)
        live = build_serving_fn(lambda x: q(x).float(), image_size=S, device="cpu", **kw)
    else:
        meta = export_embed(tr, path, batch=B, **kw)
        live = _live(tr, **kw)
    assert tr.model.backbone.training            # export left the trainer's mode as it was
    fn = load_embed(path)
    assert fn.meta == meta == read_meta(path) and meta["int8"] == (pipeline == "int8")
    x = _pixels(1)
    got = fn(x)
    assert got.shape == (B, 512) and got.dtype == torch.float32 and got.device.type == "cpu"
    assert torch.equal(got, live(x))


@pytest.mark.parametrize("kw", [{"degrade_to": 16}, {"degrade_to": 8, "flip_tta": True}],
                         ids=["degrade16", "degrade8_flip"])
def test_export_equals_crfr(trainers, tmp_path, kw):
    ref, tr = trainers
    ref_export_embed(ref, str(tmp_path / "ref.crfrx"), batch=B, **kw)
    meta = export_embed(tr, str(tmp_path / "port.crfrt"), batch=B, **kw)
    x = _pixels(2)
    want = np.asarray(ref_load_embed(str(tmp_path / "ref.crfrx"))(x))
    got = load_embed(str(tmp_path / "port.crfrt"))(x).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert set(meta) == set(read_meta(str(tmp_path / "port.crfrt")))


def test_hallucinated_artifact_equals_bicubic(trainers, tmp_path):
    """G at init (bicubic skip, zero heads) behind ↓8: the bicubic artifact
    within crfr's 1e-2, with one node of the resize op and none of the
    degrade."""
    _, tr = trainers
    sr = SRTrainer(tr.cfg, scale=4, n_priors=4, device="cpu")
    meta = export_embed(tr, str(tmp_path / "sr.crfrt"), batch=B, degrade_to=8,
                        sr_apply=sr.sr_apply(ema=False))
    export_embed(tr, str(tmp_path / "plain.crfrt"), batch=B, degrade_to=8)
    assert meta["hallucinated"] and not read_meta(str(tmp_path / "plain.crfrt"))["hallucinated"]
    fn = load_embed(str(tmp_path / "sr.crfrt"))
    x = _pixels(3)
    e_sr = fn(x).numpy()
    assert np.isfinite(e_sr).all()
    np.testing.assert_allclose(e_sr, load_embed(str(tmp_path / "plain.crfrt"))(x).numpy(),
                               atol=1e-2)
    torch.testing.assert_close(fn(x), build_serving_fn(
        lambda y: tr.backbone_apply(tr.model.backbone, y), degrade_to=8, image_size=S,
        sr_apply=sr.sr_apply(ema=False), device="cpu")(x), rtol=0, atol=0)
    targets = _targets(fn)
    assert targets.count("crfr_torch.fused_resize_normalize.default") == 1
    assert "crfr_torch.fused_degrade_normalize.default" not in targets


def _targets(fn) -> list[str]:
    """The call targets of the program's graph and of its subgraphs (the
    backbone runs inside a ``wrap_with_autocast`` subgraph)."""
    return [str(n.target) for m in fn.program.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule)
            for n in m.graph.nodes if n.op == "call_function"]


def test_graph_holds_the_custom_op(trainers, tmp_path):
    """The preprocessing is one node of the op, first in the graph; the
    plain version's two products (aten.matmul) are nowhere."""
    _, tr = trainers
    export_embed(tr, str(tmp_path / "m.crfrt"), batch=B, degrade_to=16, flip_tta=True)
    targets = _targets(load_embed(str(tmp_path / "m.crfrt")))
    ops = [t for t in targets if t.startswith("crfr_torch.")]
    assert ops == ["crfr_torch.fused_degrade_normalize.default"]
    assert not any("matmul" in t or "einsum" in t for t in targets)
    assert any("conv2d" in t for t in targets)


# ---- meta and errors -------------------------------------------------------

def test_meta_and_errors(trainers, tmp_path):
    ref, tr = trainers
    want = ref_export_embed(ref, str(tmp_path / "ref.crfrx"), batch=B)
    meta = export_embed(tr, str(tmp_path / "m.crfrt"), batch=B)
    assert set(meta) == set(want)
    assert {k: v for k, v in meta.items() if k != "platforms"} == \
        {k: v for k, v in want.items() if k != "platforms"}
    assert meta["platforms"] == ["cpu"] and meta["input_dtype"] == "uint8"
    with pytest.raises(ValueError, match="crfr \\(JAX\\) StableHLO artifact"):
        load_embed(str(tmp_path / "ref.crfrx"))
    with pytest.raises(ValueError, match="StableHLO"):
        read_meta(str(tmp_path / "ref.crfrx"))
    (tmp_path / "junk").write_bytes(b"NOTMAGIC" + b"x" * 100)
    with pytest.raises(ValueError, match="not a crfr_torch serving artifact"):
        load_embed(str(tmp_path / "junk"))
    fn = load_embed(str(tmp_path / "m.crfrt"))
    with pytest.raises(Exception, match="size"):       # the batch is static
        fn(_pixels(0, B + 1))
    # a CUDA artifact on a machine without a card names it, and never runs on the CPU
    blob = (tmp_path / "m.crfrt").read_bytes()
    (mlen,) = struct.unpack("<I", blob[8:12])
    cuda_meta = json.dumps({**meta, "platforms": ["cuda"]}).encode()
    (tmp_path / "cuda.crfrt").write_bytes(blob[:8] + struct.pack("<I", len(cuda_meta))
                                          + cuda_meta + blob[12 + mlen:])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA artifact"):
            load_embed(str(tmp_path / "cuda.crfrt"))


# ---- serve_artifact against make_server ------------------------------------

def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _call(url, data=None):
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        body = r.read()
        return (json.loads(body) if r.headers["Content-Type"] == "application/json"
                else np.load(io.BytesIO(body), allow_pickle=False))


def _serving(srv):
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return f"http://127.0.0.1:{srv.server_address[1]}", th


def _stop(srv, th):
    srv.shutdown()
    srv.server_close()
    srv.service.close()
    th.join(timeout=30)
    assert not th.is_alive()


@pytest.mark.parametrize("mutable", [False, True], ids=["bank", "mutable"])
def test_serve_artifact_equals_make_server(trainers, tmp_path, mutable):
    _, tr = trainers
    meta = export_embed(tr, str(tmp_path / "m.crfrt"), batch=B, degrade_to=16)
    live = _live(tr, degrade_to=16)
    faces = _pixels(5, 6)
    gal = live(faces).numpy()
    save_bank(str(tmp_path / "bank.npz"), quantize_bank(gal, np.arange(6) + 10))
    if mutable:
        srv = serve_artifact(str(tmp_path / "m.crfrt"), mutable=True, slab=64)
        empty = QuantBank(np.zeros((0, 512), np.int8), np.zeros(0, np.float32),
                          np.zeros(0, np.int64))
        bank = ServingBank.from_bank(empty, slab=64, device="cpu")
    else:
        srv = serve_artifact(str(tmp_path / "m.crfrt"), str(tmp_path / "bank.npz"))
        bank = load_bank(str(tmp_path / "bank.npz")).to_device("cpu")
    twin = make_server(live, meta, bank=bank, device="cpu")
    (url, th), (turl, tth) = _serving(srv), _serving(twin)
    try:
        health = _call(url + "/healthz")
        assert health["meta"] == meta and health["mutable"] == mutable
        emb = _call(url + "/embed", _npy(faces[:5]))           # 5 rows: two static batches
        np.testing.assert_array_equal(emb, gal[:5])
        steps = ([("/enroll?labels=10,11,12,13,14,15", faces), ("/match?k=3", faces),
                  ("/remove?labels=11,12", b""), ("/match?k=3", faces[:2])] if mutable
                 else [("/match?k=3", faces), ("/match?k=2", gal[:3])])
        for path, body in steps:
            data = body if isinstance(body, bytes) else _npy(body)
            assert _call(url + path, data) == _call(turl + path, data), path
        got, want = _call(url + "/gallery"), _call(turl + "/gallery")
        for f in ("q", "scale", "labels"):
            np.testing.assert_array_equal(got[f], want[f])
    finally:
        _stop(srv, th)
        _stop(twin, tth)


# ---- the CLI: export, then serve-http in a child process --------------------

def test_cli_export_then_serve_http(tmp_path, capsys):
    from crfr_torch.cli import main
    from tests.test_torch_train_cli import OVERRIDES

    ck = tmp_path / "ck"
    assert main(["train", "--preset", "casia_arcface", "--device", "cpu", *OVERRIDES,
                 f"train.checkpoint_dir={ck}", "--max-steps", "1"]) == 0
    art = str(tmp_path / "m.crfrt")
    assert main(["export", "--ckpt", str(ck), "--out", art, "--batch", "4", "--degrade", "16",
                 "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["out"] == art and out["batch"] == 4 and out["degrade_to"] == 16
    assert out["platforms"] == ["cpu"] and not out["int8"]
    assert main(["export", "--ckpt", str(ck), "--out", str(tmp_path / "q.crfrt"),
                 "--batch", "4", "--int8", "--device", "cpu"]) == 0
    assert read_meta(str(tmp_path / "q.crfrt"))["int8"]

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])]), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, "-m", "crfr_torch", "serve-http", "--artifact",
                             art, "--port", "0", "--mutable-gallery", "--gallery-slab", "64"],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = json.loads(proc.stdout.readline())
        assert line["artifact"] == art and line["mutable"] and not line["gallery"]
        url = line["serving"]
        x = _pixels(6, 3)
        emb = _call(url + "/embed", _npy(x))
        np.testing.assert_array_equal(emb, load_embed(art)(np.concatenate(
            [x, np.zeros((1, S, S, 3), np.uint8)])).numpy()[:3])
        assert _call(url + "/enroll", _npy(x))["labels"] == [0, 1, 2]
        top1 = [m["labels"][0] for m in _call(url + "/match?k=1", _npy(x))["matches"]]
        assert top1 == [0, 1, 2]
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            assert proc.wait(timeout=30) == 0
        finally:
            proc.kill()
            proc.stdout.close()
            proc.stderr.close()
