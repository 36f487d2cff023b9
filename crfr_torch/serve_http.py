"""HTTP serving daemon for an embed function (crfr/serve_http.py).

- ``GET  /healthz`` → JSON: ``meta``, gallery size, dispatch count.
- ``POST /embed``   → body: ``.npy`` bytes, (B', S, S, 3) uint8/f32 raw
                      pixels; response: ``.npy`` bytes (B', D) f32
                      embeddings. Any B': requests are coalesced into the
                      static batch ``meta["batch"]``.

The gallery endpoints (``/match``, ``/enroll``, ``/remove``, ``/gallery``)
need the int8 bank, which is not ported yet; they answer 400, as the
reference's server does with no bank loaded.

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
from urllib.parse import urlparse

import numpy as np
import torch

from crfr_torch.device import resolve_device


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
                port: int = 0, window_ms: float = 2.0,
                device: str | torch.device = "cuda") -> ThreadingHTTPServer:
    """Build (not start) the HTTP server around ``fn`` (e.g.
    ``serve.build_serving_fn``). ``meta`` carries ``batch`` (the static
    batch), ``image_size`` and ``input_dtype``. Returns the server;
    ``server.service`` is the EmbedService (close it on shutdown);
    ``server.server_address`` has the bound port."""
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

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/gallery":
                return self._fail(400, "no gallery bank loaded")
            if path != "/healthz":
                return self._fail(404, "unknown path")
            info = {"ok": True, "meta": meta, "gallery": 0, "mutable": False,
                    "dispatches": service.dispatches}
            self._send(200, json.dumps(info).encode())

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path in ("/remove", "/enroll"):
                self._body()                     # drain any body bytes
                return self._fail(400, "gallery is not mutable "
                                       "(start with --mutable-gallery)")
            try:
                arr = _load_npy(self._body())
            except Exception as e:               # noqa: BLE001
                return self._fail(400, f"body must be .npy bytes: {e}")
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
                    want = np.dtype(meta.get("input_dtype", "uint8"))
                    emb = service.submit(arr.astype(want, copy=False))
                except Exception as e:           # noqa: BLE001
                    return self._fail(500, str(e))
                return self._send(200, _npy_bytes(np.asarray(emb)),
                                  "application/octet-stream")
            if parsed.path == "/match":
                return self._fail(400, "no gallery bank loaded "
                                       "(start with --gallery-npz)")
            return self._fail(404, "unknown path")

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.service = service                        # type: ignore[attr-defined]
    return srv
