"""HTTP serving daemon for an embed function and an int8 gallery bank
(crfr/serve_http.py). ``serve_artifact`` serves a ``crfr_torch.serve``
artifact (``python -m crfr_torch serve-http --artifact``).

- ``GET  /healthz``      → JSON: ``meta``, gallery size, ``mutable``,
                           dispatch count.
- ``POST /embed``        → body: ``.npy`` bytes, (B', S, S, 3) uint8/f32 raw
                           pixels; response: ``.npy`` bytes (B', D) f32
                           embeddings. Any B': requests are coalesced into
                           the static batch ``meta["batch"]``.
- ``POST /match?k=5``    → body: ``.npy`` probes, raw pixels (4-d, embedded
                           first) or embeddings (2-d); response: JSON top-k
                           labels and scores per probe against the bank
                           (``eval/bank.py::topk_matches_bank``). ``approx``
                           and ``recall`` are accepted (selection is exact).

With a ``ServingBank`` (online enroll and remove) three more endpoints work:

- ``POST /enroll[?labels=7,8]`` → body: ``.npy`` pixels (4-d) or embeddings
                           (2-d); rows are quantized and written; labels are
                           minted past the current max when omitted.
                           Response: JSON ``{enrolled, labels, gallery}``.
- ``POST /remove?labels=3,4`` → tombstone rows by label; response JSON
                           ``{removed, gallery}``.
- ``GET  /gallery``      → compacted ``.npz`` snapshot bytes (what
                           ``save_bank`` writes).

Without a bank the gallery endpoints answer 400, with ``crfr``'s texts.

``EmbedService`` owns one worker thread that drains a queue of pending
requests, concatenates them, pads to the static batch, uploads it to the
device, runs the function and scatters the rows back, so concurrent small
requests share device calls. ``window_ms`` bounds the added latency.
Standard library only; numpy ``.npy`` is the wire format.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from crfr_torch.device import resolve_device
from crfr_torch.eval.bank import QuantBank, _np, topk_matches_bank


class EmbedService:
    """Coalescing batcher around a fixed-batch embed callable.

    ``fn``: (B, S, S, 3) tensor on ``device`` → (B, D) tensor; ``batch``:
    the static B. ``submit`` is thread-safe and returns that request's rows
    as numpy when its batch has run. Oversized requests are chunked.
    """

    def __init__(self, fn: Callable, batch: int, window_ms: float = 2.0,
                 device: str | torch.device = "cuda"):
        self.fn = fn
        self.batch = int(batch)
        self.window_s = float(window_ms) / 1e3
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.dispatches = 0                      # device calls run
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side --------------------------------------------------
    def submit(self, images: np.ndarray) -> np.ndarray:
        images = np.ascontiguousarray(images)
        done = threading.Event()
        slot: dict = {}
        self._q.put((images, slot, done))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def close(self):
        self._stop.set()
        self._q.put(None)
        self._worker.join(timeout=5)

    # -- worker side --------------------------------------------------
    def _embed(self, chunk: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(chunk).to(self.device)
        with torch.inference_mode():
            return self.fn(x).float().cpu().numpy()

    def _run(self):
        while not self._stop.is_set():
            item = self._q.get()
            if item is None:
                continue
            batch_items = [item]
            rows = item[0].shape[0]
            # coalesce whatever arrives within ONE window of the first
            # request, up to B rows; the deadline is absolute, so a steady
            # trickle cannot extend a request's wait past window_ms
            t_end = time.monotonic() + self.window_s
            while rows < self.batch:
                left = t_end - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch_items.append(nxt)
                rows += nxt[0].shape[0]
            try:
                x = np.concatenate([it[0] for it in batch_items], axis=0)
                outs = []
                for s in range(0, len(x), self.batch):
                    chunk = x[s:s + self.batch]
                    pad = self.batch - len(chunk)
                    if pad:
                        chunk = np.concatenate(
                            [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
                    outs.append(self._embed(chunk)[:self.batch - pad or None])
                    self.dispatches += 1
                y = np.concatenate(outs, axis=0)
                off = 0
                for arr, slot, done in batch_items:
                    slot["result"] = y[off:off + arr.shape[0]]
                    off += arr.shape[0]
                    done.set()
            except Exception as e:                       # noqa: BLE001
                for _, slot, done in batch_items:
                    slot["error"] = e
                    done.set()


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _load_npy(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


def make_server(fn: Callable, meta: dict, host: str = "127.0.0.1",
                port: int = 0, bank=None, window_ms: float = 2.0,
                default_k: int = 5,
                device: str | torch.device = "cuda") -> ThreadingHTTPServer:
    """Build (not start) the HTTP server around ``fn`` (e.g.
    ``serve.build_serving_fn``). ``meta`` carries ``batch`` (the static
    batch), ``image_size`` and ``input_dtype``. ``bank`` is None, a
    ``QuantBank.to_device()`` or a ``ServingBank``; it is scanned on its
    own device (a host bank on CUDA, uploaded on every match). Returns the server; ``server.service`` is
    the EmbedService (close it on shutdown); ``server.server_address`` has
    the bound port."""
    service = EmbedService(fn, batch=int(meta.get("batch", 256)),
                           window_ms=window_ms, device=device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):               # quiet by default
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _fail(self, code: int, msg: str):
            self._send(code, json.dumps({"error": msg}).encode())

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        def _parse_labels(self, qs) -> np.ndarray | None:
            raw = qs.get("labels", [""])[0]
            if not raw:
                return None
            return np.asarray([int(v) for v in raw.split(",") if v], np.int64)

        def _embed_pixels(self, arr: np.ndarray) -> np.ndarray:
            want = np.dtype(meta.get("input_dtype", "uint8"))
            return service.submit(arr.astype(want, copy=False))

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/gallery":
                if bank is None:
                    return self._fail(400, "no gallery bank loaded")
                snap = (bank.snapshot() if hasattr(bank, "snapshot")
                        else QuantBank(q=_np(bank.q), scale=_np(bank.scale),
                                       labels=_np(bank.labels).astype(np.int64)))
                buf = io.BytesIO()
                np.savez(buf, q=snap.q, scale=snap.scale, labels=snap.labels)
                return self._send(200, buf.getvalue(), "application/octet-stream")
            if path != "/healthz":
                return self._fail(404, "unknown path")
            info = {"ok": True, "meta": meta,
                    "gallery": (len(bank) if bank is not None else 0),
                    "mutable": hasattr(bank, "enroll"),
                    "dispatches": service.dispatches}
            self._send(200, json.dumps(info).encode())

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path == "/remove":
                # no .npy body: labels come from the query string
                if not hasattr(bank, "remove"):
                    return self._fail(400, "gallery is not mutable "
                                           "(start with --mutable-gallery)")
                self._body()                     # drain any body bytes
                try:
                    rm = self._parse_labels(parse_qs(parsed.query))
                    if rm is None or rm.size == 0:
                        return self._fail(400, "need ?labels=1,2,...")
                    removed = bank.remove(rm)
                except Exception as e:           # noqa: BLE001
                    return self._fail(500, str(e))
                return self._send(200, json.dumps(
                    {"removed": removed, "gallery": len(bank)}).encode())
            try:
                arr = _load_npy(self._body())
            except Exception as e:               # noqa: BLE001
                return self._fail(400, f"body must be .npy bytes: {e}")
            if parsed.path == "/enroll":
                return self._enroll(arr, parse_qs(parsed.query))
            if parsed.path == "/embed":
                want_s = int(meta.get("image_size", 0))
                if arr.ndim != 4 or (want_s and
                                     arr.shape[1:] != (want_s, want_s, 3)):
                    # reject BEFORE submit: a wrong-shape request inside a
                    # coalesced batch would fail every request in it
                    return self._fail(400,
                                      f"expect (B, {want_s}, {want_s}, 3), "
                                      f"got {arr.shape}")
                try:
                    # one input dtype per batch, so mixed-dtype clients
                    # cannot poison a coalesced batch
                    emb = self._embed_pixels(arr)
                except Exception as e:           # noqa: BLE001
                    return self._fail(500, str(e))
                return self._send(200, _npy_bytes(np.asarray(emb)),
                                  "application/octet-stream")
            if parsed.path == "/match":
                return self._match(arr, parse_qs(parsed.query))
            return self._fail(404, "unknown path")

        def _enroll(self, arr: np.ndarray, qs: dict):
            if not hasattr(bank, "enroll"):
                return self._fail(400, "gallery is not mutable "
                                       "(start with --mutable-gallery)")
            try:
                labels = self._parse_labels(qs)
                if arr.ndim == 4:                # raw pixels: embed first
                    arr = self._embed_pixels(arr)
                if arr.ndim != 2:
                    return self._fail(400, f"bad rows shape {arr.shape}")
                if labels is not None and labels.shape[0] != arr.shape[0]:
                    return self._fail(400, f"{labels.shape[0]} labels "
                                           f"for {arr.shape[0]} rows")
                got = bank.enroll(np.asarray(arr, np.float32), labels=labels)
            except Exception as e:               # noqa: BLE001
                return self._fail(500, str(e))
            return self._send(200, json.dumps(
                {"enrolled": int(arr.shape[0]), "labels": [int(v) for v in got],
                 "gallery": len(bank)}).encode())

        def _match(self, arr: np.ndarray, qs: dict):
            if bank is None:
                return self._fail(400, "no gallery bank loaded "
                                       "(start with --gallery-npz)")
            k = int(qs.get("k", [default_k])[0])
            approx = qs.get("approx", ["0"])[0] not in ("0", "", "false")
            # ?recall=0.999 sets the recall target (implies approx; the
            # port selects exactly either way, see identification._approx_cfg)
            rq = qs.get("recall", [""])[0]
            if rq:
                try:
                    approx = float(rq)
                except ValueError:
                    return self._fail(400, f"bad recall {rq!r}")
            try:
                if arr.ndim == 4:                # raw pixels: embed first
                    want_s = int(meta.get("image_size", 0))
                    if want_s and arr.shape[1:] != (want_s, want_s, 3):
                        return self._fail(400, f"expect (B, {want_s}, {want_s}, 3) "
                                               f"pixels, got {arr.shape}")
                    arr = self._embed_pixels(arr)
                if arr.ndim != 2:
                    return self._fail(400, f"bad probe shape {arr.shape}")
                # the same (N ≥ 32, k ≥ 16) power-of-two buckets as crfr, so
                # both packages scan the same shapes for a request
                p = np.asarray(arr, np.float32)
                n = p.shape[0]
                nb = 1 << max(5, (n - 1).bit_length())
                kb = 1 << max(4, (k - 1).bit_length())
                if nb != n:
                    p = np.pad(p, ((0, nb - n), (0, 0)))
                scores, labels = topk_matches_bank(p, bank, k=kb, approx=approx)
                scores, labels = scores[:n, :k], labels[:n, :k]
            except Exception as e:               # noqa: BLE001
                return self._fail(500, str(e))
            out = {"k": k, "gallery": len(bank),
                   "matches": [{"labels": labels[i].tolist(),
                                "scores": [round(float(s), 4) for s in scores[i]]}
                               for i in range(len(labels))]}
            return self._send(200, json.dumps(out).encode())

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.service = service                        # type: ignore[attr-defined]
    return srv


def serve_artifact(artifact: str, gallery_npz: str = "", host: str = "127.0.0.1",
                   port: int = 0, window_ms: float = 2.0, mutable: bool = False,
                   slab: int = 0) -> ThreadingHTTPServer:
    """Load a serving artifact (``serve.load_embed``) and, optionally, an
    int8 ``.npz`` bank, and return a ready (not started) server on the
    artifact's device (its ``platforms``).

    The bank is uploaded to that device (a host bank would be uploaded on
    every match). ``mutable=True`` serves it as a ``ServingBank`` (online
    ``/enroll`` and ``/remove``); without a ``gallery_npz`` it starts empty
    at the artifact's ``embedding_dim``. ``slab`` overrides the capacity's
    rounding slab (``ServingBank.SLAB`` when 0)."""
    from crfr_torch.eval.bank import ServingBank, load_bank
    from crfr_torch.serve import load_embed

    fn = load_embed(artifact)
    device = resolve_device(fn.meta["platforms"][0])
    bank = None
    if gallery_npz:
        host_bank = load_bank(gallery_npz)
        bank = (ServingBank.from_bank(host_bank, slab=slab, device=device) if mutable
                else host_bank.to_device(device))
    elif mutable:
        d = int(fn.meta.get("embedding_dim", 512))
        empty = QuantBank(q=np.zeros((0, d), np.int8), scale=np.zeros(0, np.float32),
                          labels=np.zeros(0, np.int64))
        bank = ServingBank.from_bank(empty, slab=slab, device=device)
    return make_server(fn, fn.meta, host=host, port=port, bank=bank, window_ms=window_ms,
                       device=device)
