"""face.evoLVe import, packing and the dataset readers of the port on the CPU
against crfr's: ``load_face_evolve_state_dict`` of crfr's
``export_face_evolve_state_dict`` output gives crfr's embeddings (IR-18 and
IR-SE-18 at 32 px with drawn BN statistics, float32, atol 1e-4) and the
export gives crfr's dict bit for bit; ``import-torch`` writes a checkpoint
that ``Trainer`` restores to those weights; ``pack_image_folder``,
``write_mx_record`` and ``convert_rec`` write crfr's bytes (with
``write_pack``) and ``MXFaceSource`` reads crfr's files as crfr does;
``save_bin`` writes crfr's bytes, ``load_bin`` reads crfr's set as crfr
does and ``evaluate_bin`` gives crfr's result for the same embedder; the
``pack`` command; the dataset readers."""

import io
import json
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from flax import nnx

from crfr.cli import main as ref_main
from crfr.data import bins as ref_bins
from crfr.data import datasets as ref_datasets
from crfr.data import mxrec as ref_mxrec
from crfr.data import records as ref_records
from crfr.models.irse import IRBackbone as RefIRBackbone
from crfr.train.torch_import import export_face_evolve_state_dict as ref_export
from crfr_torch.cli import main
from crfr_torch.data import bins, datasets, mxrec, records
from crfr_torch.models.convert import params_from_jax
from crfr_torch.models.irse import build_backbone
from crfr_torch.train.torch_import import (export_face_evolve_state_dict,
                                           load_face_evolve_state_dict)
from tests.test_torch_irse import flat_state
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)

S = 32


def _ref_model(use_se: bool, seed: int = 5):
    """crfr's IR(-SE)-18 at 32 px, float32, with BN statistics drawn so
    that the import of every one of them shows."""
    jm = RefIRBackbone(depth="18", use_se=use_se, input_size=S, dtype=jnp.float32,
                       rngs=nnx.Rngs(seed))
    rng = np.random.default_rng(seed)
    for _, m in nnx.iter_graph(jm):
        if isinstance(m, nnx.BatchNorm):
            n = m.mean.value.shape[0]
            m.mean.value = jnp.asarray(rng.normal(0, 0.3, n), jnp.float32)
            m.var.value = jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32)
            m.scale.value = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
            m.bias.value = jnp.asarray(rng.normal(0, 0.2, n), jnp.float32)
    return jm


def _port_model(use_se: bool):
    return build_backbone("ir_se_18" if use_se else "ir_18", input_size=S).eval()


@pytest.mark.parametrize("use_se", [False, True], ids=["ir_18", "ir_se_18"])
def test_face_evolve_import_equals_crfr(use_se):
    jm = _ref_model(use_se)
    sd = ref_export(jm)
    tm = load_face_evolve_state_dict(_port_model(use_se), sd)
    x = np.random.default_rng(0).normal(0, 1, (3, S, S, 3)).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # torch tensors (a real checkpoint's) load the same
    tm2 = load_face_evolve_state_dict(_port_model(use_se),
                                      {k: torch.from_numpy(v) for k, v in sd.items()})
    for k, v in tm.state_dict().items():
        assert torch.equal(v, tm2.state_dict()[k]), k


@pytest.mark.parametrize("use_se", [False, True], ids=["ir_18", "ir_se_18"])
def test_face_evolve_export_equals_crfr(use_se):
    jm = _ref_model(use_se, seed=6)
    want = ref_export(jm)
    tm = _port_model(use_se)
    tm.load_state_dict(params_from_jax(flat_state(jm)))
    got = export_face_evolve_state_dict(tm)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    back = load_face_evolve_state_dict(_port_model(use_se), got)
    for k, v in tm.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, back.state_dict()[k]), k


def test_import_rejects_a_shape_that_does_not_fit():
    sd = ref_export(_ref_model(False))
    sd["input_layer.0.weight"] = sd["input_layer.0.weight"][:32]
    with pytest.raises(ValueError, match="does not fit"):
        load_face_evolve_state_dict(_port_model(False), sd)


def test_import_torch_cli_restores(tmp_path, capsys):
    from crfr_torch.configs import get_config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.loop import Trainer

    jm = _ref_model(False, seed=7)
    sd = ref_export(jm)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "b.pth")
    ov = ["model.backbone=ir_18", "model.compute_dtype=float32", "model.dropout=0.0",
          f"data.image_size={S}", f"model.input_size={S}", "data.num_classes=4"]
    assert main(["import-torch", "--torch-ckpt", str(tmp_path / "b.pth"), "--out",
                 str(tmp_path / "ck"), "--device", "cpu", *ov]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"out": str(tmp_path / "ck"), "keys": len(sd)}
    ck = Checkpointer(str(tmp_path / "ck"))
    assert ck.steps() == [0] and ck.restore_config()["model"]["backbone"] == "ir_18"
    tr = Trainer(get_config("casia_arcface", ov), device="cpu")
    tr.state = ck.restore(tr.state)
    x = np.random.default_rng(1).normal(0, 1, (2, S, S, 3)).astype(np.float32)
    got = tr.backbone_apply(tr.model.backbone, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(x), train=False)), atol=1e-4)


# ---- packing and the MX reader ----------------------------------------------

def _tree(root, rng):
    """Three identities; images of three sizes (two need the resize), and a
    file PIL cannot open."""
    for c, ident in enumerate(("bob", "amy", "cal")):
        d = root / ident
        d.mkdir(parents=True)
        for j, size in enumerate((S, S + 8, 20)):
            Image.fromarray(rng.integers(0, 256, (size, size, 3)).astype(np.uint8)).save(
                d / f"{j}.png")
        (d / "notes.txt").write_text("not an image")


def test_pack_image_folder_writes_crfrs_bytes(tmp_path):
    _tree(tmp_path / "tree", np.random.default_rng(0))
    got = records.pack_image_folder(str(tmp_path / "tree"), str(tmp_path / "a.crfrpack"),
                                    size=S)
    want = ref_records.pack_image_folder(str(tmp_path / "tree"), str(tmp_path / "b.crfrpack"),
                                         size=S, writer=ref_records.write_pack)
    assert got == want == (9, 3)
    assert (tmp_path / "a.crfrpack").read_bytes() == (tmp_path / "b.crfrpack").read_bytes()
    src = records.PackSource(str(tmp_path / "a.crfrpack"))
    assert [src[i][0] for i in range(len(src))] == [0] * 3 + [1] * 3 + [2] * 3
    assert src[0][1].shape == (S, S, 3)


def _encoded(rng, n, fmt="PNG"):
    out = []
    for i in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (24, 24, 3)).astype(np.uint8)).save(buf, fmt)
        out.append((float(i % 3), buf.getvalue()))
    return out


@pytest.mark.parametrize("meta", [False, True], ids=["im2rec", "insightface"])
def test_mx_records_equal_crfrs(tmp_path, meta):
    recs = _encoded(np.random.default_rng(1), 6)
    assert mxrec.write_mx_record(str(tmp_path / "a.rec"), recs, insightface_meta=meta) == 6
    ref_mxrec.write_mx_record(str(tmp_path / "b.rec"), recs, insightface_meta=meta)
    for ext in (".rec", ".idx"):
        assert (tmp_path / f"a{ext}").read_bytes() == (tmp_path / f"b{ext}").read_bytes()
    src, ref = mxrec.MXFaceSource(str(tmp_path / "b.rec")), ref_mxrec.MXFaceSource(
        str(tmp_path / "b.rec"))
    assert len(src) == len(ref) == 6
    for i in range(6):
        (la, a), (lb, b) = src[i], ref[i]
        assert la == lb and np.array_equal(a, b)
    n = mxrec.convert_rec(str(tmp_path / "b.rec"), str(tmp_path / "a.crfrpack"))
    m = ref_mxrec.convert_rec(str(tmp_path / "b.rec"), str(tmp_path / "b.crfrpack"),
                              writer=ref_records.write_pack)
    assert n == m == (6, 3)
    assert (tmp_path / "a.crfrpack").read_bytes() == (tmp_path / "b.crfrpack").read_bytes()


def test_mx_irheader_and_bad_magic(tmp_path):
    for label in (7.0, [3.0, 9.0]):
        blob = mxrec.pack_irheader(label, b"xyz", rec_id=4)
        assert blob == ref_mxrec.pack_irheader(label, b"xyz", rec_id=4)
        got, want = mxrec.unpack_irheader(blob), ref_mxrec.unpack_irheader(blob)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1] == b"xyz"
    rec = str(tmp_path / "bad.rec")
    mxrec.write_mx_record(rec, [(0.0, b"ab")])
    with open(rec, "r+b") as f:
        f.write(struct.pack("<I", 0xDEAD))
    with pytest.raises(ValueError, match="magic"):
        mxrec.MXIndexedRecordIO(rec).read_idx(0)


def test_pack_cli(tmp_path, capsys):
    rng = np.random.default_rng(2)
    _tree(tmp_path / "tree", rng)
    mxrec.write_mx_record(str(tmp_path / "t.rec"), _encoded(rng, 5), insightface_meta=True)
    for name, argv in (("tree", ["--root", str(tmp_path / "tree"), "--size", str(S)]),
                       ("rec", ["--from-rec", str(tmp_path / "t.rec")])):
        assert main(["pack", *argv, "--out", str(tmp_path / f"{name}.crfrpack")]) == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert ref_main(["pack", *argv, "--out", str(tmp_path / f"ref_{name}.crfrpack")]) == 0
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert {**got, "out": ""} == {**want, "out": ""}
        assert (tmp_path / f"{name}.crfrpack").read_bytes() == \
            (tmp_path / f"ref_{name}.crfrpack").read_bytes()
    with pytest.raises(ValueError, match="ArrayRecord"):
        main(["pack", "--root", str(tmp_path / "tree"), "--out", str(tmp_path / "x.array_record")])
    with pytest.raises(ValueError, match="--root"):
        main(["pack", "--out", str(tmp_path / "x.crfrpack")])


# ---- insightface .bin sets ---------------------------------------------------

@pytest.fixture()
def bin_pairs():
    from crfr_torch.data.render import RenderedIdentities

    ren = RenderedIdentities(8, image_size=S, seed=3)
    i1, i2, issame = ren.eval_pairs(np.random.default_rng(4), 8)
    u8 = lambda a: np.clip(np.rint(a), 0, 255).astype(np.uint8)  # noqa: E731
    return u8(i1), u8(i2), issame


def test_bins_equal_crfrs(tmp_path, bin_pairs):
    i1, i2, issame = bin_pairs
    bins.save_bin(str(tmp_path / "a.bin"), i1, i2, issame)
    ref_bins.save_bin(str(tmp_path / "b.bin"), i1, i2, issame)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    for size in (S, 24):
        got, want = bins.load_bin(str(tmp_path / "b.bin"), size), \
            ref_bins.load_bin(str(tmp_path / "b.bin"), size)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    proj = np.random.default_rng(5).normal(size=(S * S * 3, 32)).astype(np.float32)

    def embed(x):
        return np.asarray(x, np.float32).reshape(len(x), -1) / 255.0 @ proj

    got = bins.evaluate_bin(str(tmp_path / "b.bin"), lambda x: torch.from_numpy(embed(x)),
                            batch_size=8, image_size=S, n_folds=4, device="cpu")
    want = ref_bins.evaluate_bin(str(tmp_path / "b.bin"), embed, batch_size=8, image_size=S,
                                 n_folds=4)
    assert got.accuracy_mean == want.accuracy_mean
    assert got.eer == pytest.approx(want.eer, abs=1e-6)


def test_bins_name_pil_when_missing(tmp_path, bin_pairs, monkeypatch):
    i1, i2, issame = bin_pairs
    bins.save_bin(str(tmp_path / "a.bin"), i1, i2, issame)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        bins.load_bin(str(tmp_path / "a.bin"))


# ---- dataset readers -----------------------------------------------------------

def test_dataset_readers_equal_crfrs(tmp_path):
    rng = np.random.default_rng(6)
    _tree(tmp_path / "tree", rng)
    got, want = datasets.FolderDataset(str(tmp_path / "tree"), S), \
        ref_datasets.FolderDataset(str(tmp_path / "tree"), S)
    assert got.samples == want.samples and got.num_classes == want.num_classes == 3
    assert len(got) == 9 and np.array_equal(got[4][0], want[4][0]) and got[4][1] == want[4][1]

    (tmp_path / "lfw.txt").write_text("2 3\nAl 1 2\nAl 3 Bo 1\n\nBo 2 4\nxx\n")
    got, want = datasets.parse_lfw_pairs(str(tmp_path / "lfw.txt"), "/r"), \
        ref_datasets.parse_lfw_pairs(str(tmp_path / "lfw.txt"), "/r")
    assert (got.path1, got.path2, got.n_folds) == (want.path1, want.path2, want.n_folds) == \
        (["/r/Al/Al_0001.jpg", "/r/Al/Al_0003.jpg", "/r/Bo/Bo_0002.jpg"],
         ["/r/Al/Al_0002.jpg", "/r/Bo/Bo_0001.jpg", "/r/Bo/Bo_0004.jpg"], 2)
    assert np.array_equal(got.issame, want.issame)

    (tmp_path / "gen.txt").write_text("a.jpg b.jpg 1\nc.jpg d.jpg 0\nbad line\ne f TRUE\n")
    got, want = datasets.parse_generic_pairs(str(tmp_path / "gen.txt"), "/r"), \
        ref_datasets.parse_generic_pairs(str(tmp_path / "gen.txt"), "/r")
    assert (got.path1, got.path2) == (want.path1, want.path2)
    assert np.array_equal(got.issame, want.issame) and got.issame.tolist() == [True, False, True]

    for d, names in (("g", ["3_frontal.jpg", "12_frontal.png", "x.jpg"]),
                     ("p", ["3_cam1_1.jpg", "3_cam2_2.jpg", "12_cam5_1.png", "9_cam1.jpg"])):
        (tmp_path / d).mkdir()
        for n in names:
            (tmp_path / d / n).write_bytes(b"")
    for dist in (1, 2, 3):
        got = datasets.scface_split(str(tmp_path / "g"), str(tmp_path / "p"), dist)
        want = ref_datasets.scface_split(str(tmp_path / "g"), str(tmp_path / "p"), dist)
        assert (got.gallery_paths, got.probe_paths) == (want.gallery_paths, want.probe_paths)
        assert np.array_equal(got.gallery_labels, want.gallery_labels)
        assert np.array_equal(got.probe_labels, want.probe_labels)

    for name, lines in (("gal", "a.png 1\nb.png 2\n"), ("mat", "c.png 1\n"),
                        ("unm", "d.png 7\ne e.png 8\n")):
        (tmp_path / f"{name}.txt").write_text(lines)
    args = [str(tmp_path / f"{n}.txt") for n in ("gal", "mat", "unm")]
    got, want = datasets.open_set_split(*args, root="/r"), \
        ref_datasets.open_set_split(*args, root="/r")
    assert (got.gallery_paths, got.probe_paths) == (want.gallery_paths, want.probe_paths)
    for f in ("gallery_labels", "probe_labels", "probe_mated"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
