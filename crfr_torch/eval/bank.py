"""int8 embedding banks: quantized gallery storage and scoring for
large-scale identification serving (crfr/eval/bank.py).

Embeddings are unit-normalized, so per-row symmetric int8 (scale =
absmax / 127) keeps each coordinate to ~0.4% of its range. A bank is a
quarter of an f32 gallery's bytes, and a scan scores ŝ = (q_p·q_g)·s_p·s_g
≈ cosine. Per-row quantization makes enroll and remove exact: a row's
(q, scale) depends on that row alone.

File format: ``.npz`` with arrays ``q`` (M, D) int8, ``scale`` (M,) f32,
``labels`` (M,) int64, the same files ``crfr`` reads and writes.

Device arrays are torch tensors; labels stay int64 on the card, but the
int32 label-range check is kept so the same inputs raise the same errors as
in ``crfr``. ``topk_matches_bank`` runs on the bank's device: on CUDA it
goes through the fused three-phase path (``ops/bank_scan.py``, the
``bank_tilemax`` kernel) by default, on the CPU through the scan
``streaming_topk_q``. ``crfr`` defaults to its scan because its Pallas
kernel's DMA on the TPU read the bank slower than XLA's own scan; that
reason does not carry over to the H100 (PERF.md has both paths' times).

On a ``mesh`` of more than one device (``parallel.mesh``, one process per
device) each rank uploads only its contiguous slice of the bank's rows
and scans it, through the fused path on CUDA when the slice holds at
least 128·k rows (one ``bank_tilemax`` launch per rank per scan); the k
candidates of every rank are merged as in ``identification.topk_matches``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from crfr_torch.device import device_of, mesh_world, resolve_device
from crfr_torch.eval.identification import (_approx_cfg, _as_tensor, _auto_block,
                                            _block_topk, _log_exact_once, _merge, _pad_rows,
                                            merge_shards, shard_rows)
from crfr_torch.ops.bank_scan import MAX_D, bank_topk_fused

FUSED_TILE = 128


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class QuantBank:
    q: np.ndarray | torch.Tensor          # (M, D) int8: normalized rows / scale
    scale: np.ndarray | torch.Tensor      # (M,) f32 per-row dequant scale
    labels: np.ndarray | torch.Tensor     # (M,) int64 identity labels (−1 = padding)

    def __len__(self) -> int:
        return int(self.q.shape[0])

    def dequantize(self) -> np.ndarray:
        """→ (M, D) f32 ≈ the normalized embeddings (test golden)."""
        return _np(self.q).astype(np.float32) * _np(self.scale)[:, None]

    def to_device(self, device: str | torch.device = "cuda") -> "QuantBank":
        """Device-resident copy (fields become tensors on ``device``). A
        serving daemon does this once at startup: a host bank is uploaded
        again on every scan."""
        dev = resolve_device(device)
        _check_label_range(self.labels)
        return QuantBank(q=_as_tensor(self.q, dev, torch.int8),
                         scale=_as_tensor(self.scale, dev, torch.float32),
                         labels=_as_tensor(self.labels, dev, torch.int64))


def _check_label_range(labels) -> None:
    """Refuse labels outside int32, as ``crfr`` does (its device banks hold
    int32 labels), so a bank moves between the two packages unchanged."""
    lbl = _np(labels)
    if lbl.size and (int(lbl.max()) >= 2 ** 31 or int(lbl.min()) < -2 ** 31):
        raise ValueError(
            "labels exceed int32 range: device-resident banks keep labels within "
            "int32, as crfr's do; relabel below 2**31 or keep the bank host-resident")


def quantize_probes(probe_emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe quantization recipe shared by the scan and the fused path
    (their scores are equal only because both use it): normalize rows →
    absmax / 127 scale → round half to even → clip. → (q (N, D) int8,
    scale (N,) f32), on the input's device."""
    p = probe_emb.to(torch.float32)
    p = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True).clamp(min=1e-12)
    ps = p.abs().amax(dim=-1).clamp(min=1e-12) / 127.0
    pq = torch.clamp(torch.round(p / ps[:, None]), -127, 127).to(torch.int8)
    return pq, ps


def _quantize_rows(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    # host twin of quantize_probes for building banks without a device;
    # numpy, and bit-equal to crfr's
    x = np.asarray(x, np.float32)
    x = x / np.linalg.norm(x, axis=-1, keepdims=True).clip(1e-12)
    scale = np.abs(x).max(axis=-1).clip(1e-12) / 127.0
    q = np.clip(np.round(x / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_bank(emb, labels=None) -> QuantBank:
    """Normalize rows, per-row symmetric int8. ``labels`` default to the row
    index (a pure serving bank)."""
    q, scale = _quantize_rows(emb)
    if labels is None:
        labels = np.arange(q.shape[0])
    return QuantBank(q=q, scale=scale, labels=np.asarray(labels, np.int64))


def save_bank(path: str, bank: QuantBank) -> None:
    np.savez(path, q=_np(bank.q), scale=_np(bank.scale), labels=_np(bank.labels))


def load_bank(path: str) -> QuantBank:
    with np.load(path) as z:
        return QuantBank(q=np.asarray(z["q"], np.int8),
                         scale=np.asarray(z["scale"], np.float32),
                         labels=np.asarray(z["labels"], np.int64))


def append_bank(bank: QuantBank, emb, labels=None) -> QuantBank:
    """Enroll rows into a host bank: quantize the new rows and concatenate.
    Bitwise equal to ``quantize_bank`` of the concatenated embeddings.
    ``labels`` default to fresh labels past the current max."""
    q, scale = _quantize_rows(emb)
    old_labels = _np(bank.labels)
    if labels is None:
        start = int(old_labels.max(initial=-1)) + 1
        labels = np.arange(start, start + q.shape[0])
    labels = np.asarray(labels, np.int64)
    if labels.shape != (q.shape[0],):
        raise ValueError(f"labels {labels.shape} != rows ({q.shape[0]},)")
    return QuantBank(q=np.concatenate([_np(bank.q), q]),
                     scale=np.concatenate([_np(bank.scale), scale]),
                     labels=np.concatenate([old_labels, labels]))


def remove_bank(bank: QuantBank, labels) -> QuantBank:
    """Drop every row whose label is in ``labels`` (host bank, compacting).
    The remaining rows are untouched."""
    rm = np.unique(np.asarray(labels, np.int64))
    keep = ~np.isin(_np(bank.labels), rm)
    return QuantBank(q=_np(bank.q)[keep], scale=_np(bank.scale)[keep],
                     labels=_np(bank.labels)[keep])


def _pow2_bucket(n: int, floor: int = 8) -> int:
    return 1 << max(floor.bit_length() - 1, (n - 1).bit_length())


class ServingBank:
    """Capacity-padded device bank with online enroll and remove.

    The bank is padded to a whole number of ``slab`` rows; empty slots carry
    scale 0 and label −1, the padding every scan path masks. ``enroll``
    writes pow2-bucketed row blocks after the high-water mark (bucket pad
    rows land dead and the next enroll overwrites them) and grows by whole
    slabs when the capacity is short; ``remove`` tombstones rows (scale 0,
    label −1) without compaction.

    Copy on write: a mutation builds new tensors and swaps all three under
    the lock, never writing into tensors it has published, so a scan that
    fetched ``view()`` keeps a consistent bank whatever lands after. Each
    mutation costs one capacity-sized copy on the device.

    Duck-types ``QuantBank`` (``.q/.scale/.labels/__len__``); ``__len__``
    counts live rows.
    """

    SLAB = 65536

    def __init__(self, q, scale, labels, size: int,
                 device: str | torch.device = "cuda"):
        self._lock = threading.RLock()
        self._dev = resolve_device(device)
        self._slab = self.SLAB
        _check_label_range(labels)
        # host-tracked max label: auto-label enrolls read it under the lock
        self._max_label = int(_np(labels).max(initial=-1))
        self.q = _as_tensor(q, self._dev, torch.int8)
        self.scale = _as_tensor(scale, self._dev, torch.float32)
        self.labels = _as_tensor(labels, self._dev, torch.int64)
        self.size = int(size)          # high-water mark (tombstones included)
        self._dead = 0                 # tombstoned rows below the mark

    @classmethod
    def from_bank(cls, bank: QuantBank, capacity: int = 0, slab: int = 0,
                  device: str | torch.device = "cuda") -> "ServingBank":
        """Wrap a ``QuantBank``, padding to ``capacity`` rounded up to whole
        slabs (by default one spare row past the current rows, rounded up)."""
        dev = resolve_device(device)
        slab = int(slab) or cls.SLAB
        q = _np(bank.q)
        m, d = q.shape
        cap = max(int(capacity), m + 1)
        cap = -(-cap // slab) * slab
        qp = np.zeros((cap, d), np.int8)
        sc = np.zeros(cap, np.float32)
        lbl = np.full(cap, -1, np.int64)
        qp[:m], sc[:m], lbl[:m] = q, _np(bank.scale), _np(bank.labels)
        sb = cls(qp, sc, lbl, size=m, device=dev)
        sb._slab = slab
        return sb

    def __len__(self) -> int:
        return self.size - self._dead

    @property
    def capacity(self) -> int:
        return int(self.q.shape[0])

    def snapshot(self) -> QuantBank:
        """Compacted host copy (live rows, original order), what ``save_bank``
        persists; labels int64."""
        view = self.view()
        q, sc, lbl = _np(view.q), _np(view.scale), _np(view.labels)
        keep = lbl >= 0
        return QuantBank(q=q[keep], scale=sc[keep], labels=lbl[keep].astype(np.int64))

    def enroll(self, emb, labels=None) -> np.ndarray:
        """Quantize and write new rows; returns the (n,) int64 labels
        assigned. Auto-labels (``labels=None``) are minted from the host-
        tracked max under the same lock as the write, so concurrent enrolls
        never mint duplicates."""
        rows, rsc = _quantize_rows(emb)
        n = rows.shape[0]
        if labels is not None:
            rlbl = np.asarray(labels, np.int64)
            if rlbl.shape != (n,):
                raise ValueError(f"labels {rlbl.shape} != rows ({n},)")
            _check_label_range(rlbl)
        with self._lock:
            if labels is None:
                start = self._max_label + 1
                rlbl = np.arange(start, start + n, dtype=np.int64)
                _check_label_range(rlbl)
            self._max_label = max(self._max_label, int(rlbl.max(initial=-1)))
            b = _pow2_bucket(n)
            pad = b - n
            if pad:
                rows = np.concatenate([rows, np.zeros((pad, rows.shape[1]), np.int8)])
                rsc = np.concatenate([rsc, np.zeros(pad, np.float32)])
                rlbl = np.concatenate([rlbl, np.full(pad, -1, np.int64)])
            if self.size + b > self.capacity:
                self._grow(self.size + b)
            end = self.size + b
            q, sc, lbl = self.q.clone(), self.scale.clone(), self.labels.clone()
            q[self.size:end] = torch.from_numpy(rows).to(self._dev)
            sc[self.size:end] = torch.from_numpy(rsc).to(self._dev)
            lbl[self.size:end] = torch.from_numpy(rlbl).to(self._dev)
            self.q, self.scale, self.labels = q, sc, lbl
            self.size += n
            return rlbl[:n].copy()

    def remove(self, labels) -> int:
        """Tombstone rows by label; returns the number of rows removed."""
        rm = np.unique(np.asarray(labels, np.int64))
        rm = rm[rm >= 0]                       # −1 is the tombstone marker
        if rm.size == 0:
            return 0
        with self._lock:
            rm_t = torch.from_numpy(rm).to(self._dev)
            dead = torch.isin(self.labels, rm_t) & (self.labels >= 0)
            removed = int(dead.sum())
            self.scale = torch.where(dead, 0.0, self.scale)
            self.labels = torch.where(dead, -1, self.labels)
            self._dead += removed
            return removed

    def view(self) -> QuantBank:
        """Consistent (q, scale, labels) for scans: mutations replace all
        three together under the lock, so a scan fetches them together too
        (``topk_matches_bank`` calls this). The tensors are never written
        after they are published, so the view stays valid."""
        with self._lock:
            return QuantBank(q=self.q, scale=self.scale, labels=self.labels)

    def _grow(self, need: int) -> None:
        cap = -(-max(need, self.capacity + 1) // self._slab) * self._slab
        m = self.size
        q = torch.zeros((cap, self.q.shape[1]), dtype=torch.int8, device=self._dev)
        sc = torch.zeros(cap, dtype=torch.float32, device=self._dev)
        lbl = torch.full((cap,), -1, dtype=torch.int64, device=self._dev)
        q[:m], sc[:m], lbl[:m] = self.q[:m], self.scale[:m], self.labels[:m]
        self.q, self.scale, self.labels = q, sc, lbl


# ---------------------------------------------------------------------------
# Quantized streaming top-k
# ---------------------------------------------------------------------------


def streaming_topk_q(probe_emb, q: torch.Tensor, scale: torch.Tensor,
                     labels: torch.Tensor, k: int = 10, block: int = 8192,
                     approx: bool | float = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-probe top-k against an int8 bank without materializing (N, M), on
    the bank's device. Probes are normalized and row-quantized; each block's
    s8×s8 product is an f32 product of the int8 values, exact while D ≤ 1024
    (every partial sum is an integer below 2²⁴), then one rescale multiply.
    Rows with label < 0 score −inf. ``approx`` is accepted; selection stays
    exact. Returns (scores (N, k), labels (N, k)) tensors."""
    if q.shape[1] > MAX_D:
        raise ValueError(f"streaming_topk_q: D must be at most {MAX_D} for exact "
                         f"float sums, got {q.shape[1]}")
    if _approx_cfg(approx)[0]:
        _log_exact_once()
    dev = q.device
    pq, ps = quantize_probes(torch.as_tensor(probe_emb).to(dev))
    pqf = pq.to(torch.float32)
    sc = scale.to(dev, torch.float32)
    lbl = labels.to(dev, torch.int64)
    n = pq.shape[0]
    top_s = torch.full((n, k), -torch.inf, dtype=torch.float32, device=dev)
    top_l = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    for s0 in range(0, q.shape[0], block):
        sblk, lblk = sc[s0:s0 + block], lbl[s0:s0 + block]
        acc = torch.matmul(pqf, q[s0:s0 + block].to(torch.float32).t())  # (N, block)
        sim = acc * (ps[:, None] * sblk[None, :])
        sim = torch.where(lblk[None, :] >= 0, sim, -torch.inf)
        top_s, top_l = _merge(top_s, top_l, *_block_topk(sim, lblk, k), k)
    return top_s, top_l


def topk_matches_bank(probe_emb, bank: QuantBank, k: int, block: int = 0, mesh=None,
                      fused: bool | None = None, approx: bool | float = False,
                      device: str | torch.device | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Per-probe top-k (scores, labels) as numpy against an int8 bank, the
    twin of ``identification.topk_matches``. Runs on ``device``, by default
    the bank's own device when it holds tensors, else CUDA. A
    ``ServingBank`` is read through one locked ``view()``.

    ``fused``: None takes the device's default, the fused three-phase path
    through the ``bank_tilemax`` kernel on CUDA and the scan on the CPU;
    True or False chooses. The fused path needs M ≥ 128·k rows; smaller banks
    always scan. ``block <= 0`` sizes the scan block from the probe count.
    A ``mesh`` of more than one device shards the rows over the process
    group's ranks, each scanning its own slice by the same rule; every rank
    returns the same result."""
    view = getattr(bank, "view", None)
    if callable(view):
        bank = view()
    world = mesh_world(mesh)
    dev = device_of(bank.q, device)
    lo, hi, m = shard_rows(len(bank), world)           # this rank's rows, padded
    q = _pad_rows(_as_tensor(bank.q[lo:hi], dev, torch.int8), m)
    sc = _pad_rows(_as_tensor(bank.scale[lo:hi], dev, torch.float32), m)
    lbl = _pad_rows(_as_tensor(bank.labels[lo:hi], dev, torch.int64), m, -1)
    p = _as_tensor(probe_emb, dev, torch.float32)
    if fused is None:
        fused = dev.type == "cuda"
    if fused and m >= FUSED_TILE * k:
        s, lab = bank_topk_fused(p, q, sc, lbl, k=k, tile=FUSED_TILE)
    else:
        block = _auto_block(block, int(p.shape[0]))
        s, lab = streaming_topk_q(p, q, sc, lbl, k=k, block=min(block, max(m, 1)),
                                  approx=approx)
    if world > 1:
        s, lab = merge_shards(s, lab, k)
    return s.cpu().numpy(), lab.cpu().numpy()
