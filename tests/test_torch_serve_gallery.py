"""The port's HTTP gallery endpoints on the CPU against crfr's server: the
same embed weights, the same bank and the same requests to both.
``/match`` with embeddings (2-d) and pixels (4-d), its buckets, ``approx``
and ``recall``; the mutable lifecycle (``/enroll``, ``/remove``,
``/gallery``); and the error paths of tests/test_serve_http.py and
tests/test_bank_lifecycle.py. Labels and status codes equal; scores, which
the servers round to 4 decimals, within 1e-4."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from crfr.eval import bank as ref_bank
from crfr.serve_http import make_server as ref_make_server
from crfr_torch.eval import bank as port_bank
from crfr_torch.serve_http import make_server

SIZE, DIM, BATCH = 8, 32, 4
META = {"batch": BATCH, "image_size": SIZE, "embedding_dim": DIM, "input_dtype": "uint8"}


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _post(url, data=b""):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _embs(rng, n, dim=DIM):
    e = np.eye(dim, dtype=np.float32)[np.arange(n) % dim]
    return (e + rng.normal(0, 0.03, e.shape)).astype(np.float32)


def _start(srv):
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    host, port = srv.server_address[:2]
    return f"http://{host}:{port}", th


def _stop(srv, th):
    srv.shutdown()
    srv.server_close()
    srv.service.close()
    th.join(timeout=30)
    assert not th.is_alive()


@pytest.fixture()
def servers(request):
    """(crfr url, port url, port bank, crfr bank) with a linear embed."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.05, (SIZE * SIZE * 3, DIM)).astype(np.float32)
    wt = torch.from_numpy(w)
    gal = _embs(rng, 6) if request.param == "mutable" else \
        rng.normal(0, 1, (50, DIM)).astype(np.float32)
    labels = np.arange(len(gal)) + (0 if request.param == "mutable" else 100)
    if request.param == "mutable":
        rb = ref_bank.ServingBank.from_bank(ref_bank.quantize_bank(gal, labels), slab=16)
        pb = port_bank.ServingBank.from_bank(port_bank.quantize_bank(gal, labels), slab=16,
                                             device="cpu")
    else:
        rb = ref_bank.quantize_bank(gal, labels)
        pb = port_bank.quantize_bank(gal, labels).to_device("cpu")
    ref_srv = ref_make_server(lambda x: np.asarray(x, np.float32).reshape(x.shape[0], -1) @ w,
                              META, port=0, bank=rb, window_ms=1.0)
    port_srv = make_server(lambda x: x.to(torch.float32).reshape(x.shape[0], -1) @ wt,
                           META, port=0, bank=pb, window_ms=1.0, device="cpu")
    (ru, rt), (pu, pt) = _start(ref_srv), _start(port_srv)
    yield ru, pu, pb, gal
    _stop(ref_srv, rt)
    _stop(port_srv, pt)


def _both(ru, pu, path, data=None, get=False):
    """The same request to both servers: equal status; JSON bodies equal
    except scores (within 1e-4); returns the port's parsed body."""
    (rs, rb), (ps, pb) = ((_get(u + path) if get else _post(u + path, data)) for u in (ru, pu))
    assert ps == rs, (path, rs, rb, ps, pb)
    if get and path == "/gallery" and ps == 200:
        return pb
    rj, pj = json.loads(rb), json.loads(pb)
    if "matches" in rj:
        for rm, pm in zip(rj["matches"], pj["matches"], strict=True):
            assert pm["labels"] == rm["labels"]
            np.testing.assert_allclose(pm["scores"], rm["scores"], rtol=0, atol=1e-4)
        rj.pop("matches"), pj.pop("matches")
    if "error" in rj:
        assert pj["error"] == rj["error"]
    else:
        assert pj == rj
    return json.loads(pb)


@pytest.mark.parametrize("servers", ["static"], indirect=True)
def test_match_embeddings_and_pixels(servers):
    ru, pu, _, gal = servers
    out = _both(ru, pu, "/match?k=3", _npy(gal[[7, 31]]))
    assert out["k"] == 3 and out["gallery"] == 50
    assert [m["labels"][0] for m in out["matches"]] == [107, 131]
    px = np.random.default_rng(1).integers(0, 256, (5, SIZE, SIZE, 3)).astype(np.uint8)
    out = _both(ru, pu, "/match?k=4", _npy(px))
    assert len(out["matches"]) == 5 and all(len(m["labels"]) == 4 for m in out["matches"])
    health = _both(ru, pu, "/healthz", get=True)
    assert health["gallery"] == 50 and health["mutable"] is False


@pytest.mark.parametrize("servers", ["static"], indirect=True)
def test_match_bucketing_and_approx(servers):
    ru, pu, _, gal = servers
    for probes, k, want in ((gal[[5]], 2, [105]), (gal[[9, 11, 40]], 4, [109, 111, 140])):
        out = _both(ru, pu, f"/match?k={k}&approx=1", _npy(probes))
        assert out["k"] == k and [m["labels"][0] for m in out["matches"]] == want
    out = _both(ru, pu, "/match?k=2&recall=0.999", _npy(gal[[5]]))
    assert out["matches"][0]["labels"][0] == 105
    _both(ru, pu, "/match?k=2&recall=abc", _npy(gal[[5]]))          # 400 on both


@pytest.mark.parametrize("servers", ["static"], indirect=True)
def test_error_paths(servers):
    ru, pu, _, _ = servers
    for path, body in (("/embed", b"not npy"),
                       ("/embed", _npy(np.zeros((3, 4), np.float32))),
                       ("/embed", _npy(np.zeros((1, 24, 24, 3), np.uint8))),
                       ("/match", b"not npy"),
                       ("/match", _npy(np.zeros((1, 24, 24, 3), np.uint8))),
                       ("/match", _npy(np.zeros((2, 3, 4), np.float32))),
                       ("/nope", _npy(np.zeros((1, SIZE, SIZE, 3), np.uint8))),
                       ("/enroll", _npy(np.zeros((1, DIM), np.float32))),
                       ("/remove?labels=1", b"")):
        out = _both(ru, pu, path, body)
        assert "error" in out, path
    st, _ = _post(pu + "/embed", _npy(np.zeros((1, SIZE, SIZE, 3), np.uint8)))
    assert st == 200                                   # the server still answers
    st, body = _get(pu + "/nope")
    assert st == 404


@pytest.mark.parametrize("servers", ["mutable"], indirect=True)
def test_mutable_lifecycle(servers):
    ru, pu, pb, _ = servers
    health = _both(ru, pu, "/healthz", get=True)
    assert health["mutable"] and health["gallery"] == 6
    new = _embs(np.random.default_rng(2), 8)[6:8]
    assert _both(ru, pu, "/enroll", _npy(new)) == {"enrolled": 2, "labels": [6, 7],
                                                     "gallery": 8}
    out = _both(ru, pu, "/match?k=2", _npy(new))
    assert [m["labels"][0] for m in out["matches"]] == [6, 7]
    assert _both(ru, pu, "/remove?labels=6") == {"removed": 1, "gallery": 7}
    out = _both(ru, pu, "/match?k=2", _npy(new))
    assert 6 not in out["matches"][0]["labels"]
    body = _both(ru, pu, "/gallery", get=True)
    z = np.load(io.BytesIO(body))
    snap = pb.snapshot()
    for f in ("q", "scale", "labels"):
        assert np.array_equal(z[f], getattr(snap, f)) and z[f].dtype == getattr(snap, f).dtype


@pytest.mark.parametrize("servers", ["mutable"], indirect=True)
def test_enroll_pixels_roundtrip_and_errors(servers):
    ru, pu, _, _ = servers
    px = np.random.default_rng(3).integers(0, 256, (1, SIZE, SIZE, 3)).astype(np.uint8)
    assert _both(ru, pu, "/enroll?labels=42", _npy(px))["labels"] == [42]
    assert _both(ru, pu, "/match?k=1", _npy(px))["matches"][0]["labels"] == [42]
    out = _both(ru, pu, "/enroll?labels=1,2", _npy(np.ones((1, DIM), np.float32)))
    assert "labels" in out["error"]
    assert "labels" in _both(ru, pu, "/remove")["error"]
    assert "rows shape" in _both(ru, pu, "/enroll", _npy(np.ones((2, 3, 4), np.float32)))["error"]


def test_no_bank_answers_400():
    srv = make_server(lambda x: x.reshape(x.shape[0], -1)[:, :DIM].float(), META, port=0,
                      window_ms=1.0, device="cpu")
    url, th = _start(srv)
    try:
        for path in ("/match", "/enroll", "/remove"):
            st, body = _post(url + path, _npy(np.zeros((1, DIM), np.float32)))
            assert st == 400, path
        assert _get(url + "/gallery")[0] == 400
        assert json.loads(_get(url + "/healthz")[1])["gallery"] == 0
    finally:
        _stop(srv, th)
