"""Identification evaluation: closed-set rank-k/CMC and open-set TPIR@FPIR
(crfr/eval/identification.py).

Every protocol entry point routes through ``topk_matches``, which never
materializes the (N, M) similarity matrix: ``streaming_topk`` walks the
gallery in blocks on the device, keeping a running per-probe top-k. A
``QuantBank`` gallery goes to ``eval.bank.topk_matches_bank`` (the int8
scan, or the fused three-phase path through the ``bank_tilemax`` kernel).

Rank/CMC from the top-k candidates is exact: the first correct-label
position in the score-sorted candidates equals the count of wrong-identity
entries above the best correct one, for any k ≥ max_rank.

Gallery labels are non-negative by convention; label −1 marks padding rows,
which never enter a top-k. Results are numpy, as ``crfr``'s are.

Differences from ``crfr``:
- ``top_k`` is a stable descending sort, so among equal scores the lower
  index comes first, as with ``lax.top_k`` (``torch.topk`` promises no order
  among ties on CUDA).
- ``approx`` is accepted and decoded by ``_approx_cfg``, but selection stays
  exact: PyTorch has no ``approx_max_k``, and an exact top-k meets any recall
  target. The first such call logs it once.
- A ``mesh`` of more than one device is a ``DeviceMesh`` over the ranks
  of the process group, one per device (``parallel.mesh``): each rank
  scans its contiguous slice of the gallery rows and the k candidates of
  every rank are gathered in rank order and merged; every rank returns the
  same result. A one-device mesh scans on the one device.
- The block products are f32 ``torch.matmul`` with TF32 off (PyTorch's
  default for matmul), where ``crfr`` uses ``Precision.HIGHEST``.
"""

from __future__ import annotations

import functools
import logging
from dataclasses import dataclass

import numpy as np
import torch

from crfr_torch.device import device_of, mesh_world

log = logging.getLogger(__name__)


@dataclass
class IdentificationResult:
    rank1: float
    cmc: np.ndarray                       # (max_rank,) cumulative match curve
    tpir_at_fpir: dict[float, float]      # open-set only; {} for closed set


def _normalized(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the k largest, descending, the lower
    index first among equal values."""
    s, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], idx[..., :k]


def _as_tensor(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` (array or tensor) as a contiguous tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype).contiguous()


# ---------------------------------------------------------------------------
# Streaming top-k
# ---------------------------------------------------------------------------


def _block_topk(sim: torch.Tensor, lblk: torch.Tensor, k: int, tile: int = 128
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of one (N, B) score block, hierarchical: per-tile maxima,
    the top k tiles, then a sort of only those tiles' k·tile scores (plus the
    B % tile leftovers). Exact by the tournament argument: if a top-k
    element lived in a tile outside the top k tiles by max, k tiles would
    each hold a larger element. Returns (scores (N, k), labels (N, k))."""
    n, b = sim.shape
    if b <= k:                            # block smaller than k: take all
        s, idx = top_k(sim, b)
        pad = k - b
        return (torch.nn.functional.pad(s, (0, pad), value=-torch.inf),
                torch.nn.functional.pad(lblk[idx], (0, pad), value=-1))
    t = min(tile, b)
    nt = b // t
    if nt < k or k * t + k >= b:          # tiny block: a plain sort
        s, idx = top_k(sim, k)
        return s, lblk[idx]
    bt = nt * t
    sim3 = sim[:, :bt].reshape(n, nt, t)
    tile_max = sim3.amax(dim=2)                                   # (N, T)
    _, tsel = top_k(tile_max, k)                                  # (N, k)
    cand_s = torch.gather(sim3, 1, tsel[:, :, None].expand(n, k, t)).reshape(n, k * t)
    cand_l = lblk[:bt].reshape(nt, t)[tsel].reshape(n, k * t)
    if bt < b:
        cand_s = torch.cat([cand_s, sim[:, bt:]], dim=1)
        cand_l = torch.cat([cand_l, lblk[bt:].expand(n, b - bt)], dim=1)
    s, idx = top_k(cand_s, k)
    return s, torch.gather(cand_l, 1, idx)


def _approx_cfg(approx) -> tuple[bool, float]:
    """Decode the ``approx`` flag shared by every top-k API: False → exact;
    True → approximate at recall target 0.95; a float in (0, 1) → that
    recall target; a float ≥ 1.0 → exact. The port selects exactly in every
    case (see the module docstring); the decoded flag only logs."""
    if isinstance(approx, float) and not isinstance(approx, bool):
        return approx < 1.0, min(max(approx, 1e-3), 0.9999)
    return bool(approx), 0.95


@functools.lru_cache(maxsize=1)
def _log_exact_once() -> None:
    log.info("approx selection requested: crfr_torch has no approx_max_k and "
             "selects the exact top-k, which meets any recall target")


def _merge(top_s, top_l, blk_s, blk_l, k):
    s, idx = top_k(torch.cat([top_s, blk_s], dim=1), k)
    return s, torch.gather(torch.cat([top_l, blk_l], dim=1), 1, idx)


def streaming_topk(probe_emb: torch.Tensor, gallery_emb: torch.Tensor,
                   gallery_labels: torch.Tensor, k: int = 10, block: int = 4096,
                   approx: bool | float = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k gallery matches per probe without materializing (N, M): a loop
    over gallery blocks keeping a running per-probe top-k, on the gallery's
    device. Rows with label < 0 score −inf. Returns (scores (N, k), labels
    (N, k)) tensors, sorted descending."""
    if _approx_cfg(approx)[0]:
        _log_exact_once()
    dev = gallery_emb.device
    p = _normalized(probe_emb.to(dev))
    g = _normalized(gallery_emb)
    lbl = gallery_labels.to(dev)
    n = p.shape[0]
    top_s = torch.full((n, k), -torch.inf, dtype=torch.float32, device=dev)
    top_l = torch.full((n, k), -1, dtype=lbl.dtype, device=dev)
    for s0 in range(0, g.shape[0], block):
        lblk = lbl[s0:s0 + block]
        sim = torch.matmul(p, g[s0:s0 + block].t())               # (N, block)
        sim = torch.where(lblk[None, :] >= 0, sim, -torch.inf)
        top_s, top_l = _merge(top_s, top_l, *_block_topk(sim, lblk, k), k)
    return top_s, top_l


def merge_shards(s: torch.Tensor, lab: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k over every rank's (N, k) candidates, gathered in rank order:
    the same (scores, labels) on every rank."""
    import torch.distributed as dist

    world = dist.get_world_size()
    parts_s = [torch.empty_like(s) for _ in range(world)]
    parts_l = [torch.empty_like(lab) for _ in range(world)]
    dist.all_gather(parts_s, s.contiguous())
    dist.all_gather(parts_l, lab.contiguous())
    top_s, idx = top_k(torch.cat(parts_s, dim=1), k)
    return top_s, torch.gather(torch.cat(parts_l, dim=1), 1, idx)


def shard_rows(m: int, world: int) -> tuple[int, int, int]:
    """(start, stop, rows per rank) of this rank's slice of m gallery rows,
    padded to a multiple of the world (the padding is label −1); (0, m, m)
    for one process."""
    from crfr_torch.parallel.multihost import process_index

    per = -(-m // world)
    lo = process_index() * per if world > 1 else 0
    return min(lo, m), min(lo + per, m), per


def _pad_rows(x: torch.Tensor, rows: int, value=0) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    pad = x.new_full((rows - x.shape[0], *x.shape[1:]), value)
    return torch.cat([x, pad])


def _auto_block(block: int, n_probes: int) -> int:
    """Scan block size: large blocks amortize the per-block overhead, while
    the (N, block) f32 score buffer stays at most 64M elements (256 MB)."""
    if block and block > 0:
        return block
    return int(np.clip((64 << 20) // max(n_probes, 1), 4096, 65536))


def topk_matches(probe_emb, gallery_emb, gallery_labels, k: int, block: int = 0,
                 mesh=None, approx: bool | float = False,
                 device: str | torch.device | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Per-probe top-k (scores, labels) as numpy against a gallery of any size.

    ``gallery_emb`` may be an int8 ``eval.bank.QuantBank``; scoring then runs
    ``topk_matches_bank`` with the same contract, and ``gallery_labels`` (if
    not None) overrides the bank's labels. Runs on ``device``, by default the
    gallery's own device when it is a tensor, else CUDA. ``block <= 0``
    sizes the scan block from the probe count.

    A ``mesh`` of more than one device shards the gallery rows over the
    process group's ranks (``crfr``'s ``sharded_topk``): each rank copies
    only its contiguous slice (``shard_rows``) to its device and scans it,
    then ``merge_shards``; every rank returns the same result."""
    from crfr_torch.eval.bank import QuantBank, topk_matches_bank

    world = mesh_world(mesh)
    if isinstance(gallery_emb, QuantBank):
        b = gallery_emb
        if gallery_labels is not None:
            b = QuantBank(b.q, b.scale, np.asarray(gallery_labels, np.int64))
        return topk_matches_bank(probe_emb, b, k=k, block=block, mesh=mesh, approx=approx,
                                 device=device)
    dev = device_of(gallery_emb, device)
    p = _as_tensor(probe_emb, dev)
    block = _auto_block(block, int(p.shape[0]))
    lo, hi, rows = shard_rows(int(gallery_emb.shape[0]), world)
    g = _pad_rows(_as_tensor(gallery_emb[lo:hi], dev), rows)
    labels = (gallery_labels if isinstance(gallery_labels, torch.Tensor)
              else np.asarray(gallery_labels))
    lbl = _pad_rows(_as_tensor(labels[lo:hi], dev, torch.int64), rows, -1)
    s, lab = streaming_topk(p, g, lbl, k=k, block=min(block, max(rows, 1)), approx=approx)
    if world > 1:
        s, lab = merge_shards(s, lab, k)
    return s.cpu().numpy(), lab.cpu().numpy()


def _rank_from_topk(top_labels: np.ndarray, probe_labels: np.ndarray,
                    max_rank: int) -> tuple[np.ndarray, np.ndarray]:
    """(rank1_hits (N,) bool, cmc_hits (N, max_rank) bool) from score-sorted
    top-k labels. Exact for k ≥ max_rank."""
    top_labels = np.asarray(top_labels)[:, :max_rank]
    probe_labels = np.asarray(probe_labels)
    match = top_labels == probe_labels[:, None]
    found = match.any(axis=1)
    first = np.where(found, match.argmax(axis=1), max_rank)
    cmc_hits = first[:, None] < np.arange(1, max_rank + 1)[None, :]
    return first == 0, cmc_hits


def _dense_closed_set(probe_emb, gallery_emb, probe_labels, gallery_labels,
                      max_rank: int = 20) -> tuple[torch.Tensor, torch.Tensor]:
    """One (N, M) product + rank computation: the O(N·M)-memory golden the
    streaming path is tested against. Returns (rank1_hits, cmc_hits)."""
    p = _normalized(probe_emb)
    g = _normalized(gallery_emb.to(p.device))
    sim = torch.matmul(p, g.t())                                  # (N, M)
    match = probe_labels.to(p.device)[:, None] == gallery_labels.to(p.device)[None, :]
    best_correct = torch.where(match, sim, -torch.inf).amax(dim=1)
    ranks = ((sim > best_correct[:, None]) & ~match).sum(dim=1)   # 0-indexed
    cmc_hits = ranks[:, None] < torch.arange(1, max_rank + 1, device=p.device)[None, :]
    return ranks == 0, cmc_hits


def closed_set_identification(probe_emb, gallery_emb, probe_labels, gallery_labels,
                              max_rank: int = 20, mesh=None, block: int = 0,
                              approx: bool | float = False,
                              device: str | torch.device | None = None
                              ) -> IdentificationResult:
    """SCface-style closed-set identification (every probe is enrolled),
    streaming the gallery in blocks."""
    _, labels = topk_matches(probe_emb, gallery_emb, gallery_labels, k=max_rank,
                             block=block, mesh=mesh, approx=approx, device=device)
    r1, cmc_hits = _rank_from_topk(labels, probe_labels, max_rank)
    return IdentificationResult(rank1=float(np.mean(r1)), cmc=cmc_hits.mean(axis=0),
                                tpir_at_fpir={})


def open_set_identification(probe_emb, gallery_emb, probe_labels, gallery_labels,
                            probe_mated, fpir_targets=(1e-2, 1e-1), max_rank: int = 20,
                            mesh=None, block: int = 0, approx: bool | float = False,
                            device: str | torch.device | None = None
                            ) -> IdentificationResult:
    """TinyFace / QMUL-SurvFace open-set protocol. ``probe_mated`` (N,) bool:
    True where the probe's identity is enrolled. CMC over mated probes;
    FPIR(τ) = P(top score > τ | unmated), TPIR(τ) = P(top score > τ and top-1
    correct | mated), τ from the unmated top scores' exact quantiles."""
    scores, labels = topk_matches(probe_emb, gallery_emb, gallery_labels, k=max_rank,
                                  block=block, mesh=mesh, approx=approx, device=device)
    probe_labels = np.asarray(probe_labels)
    mated = np.asarray(probe_mated, dtype=bool)
    top_sim = scores[:, 0]
    top_label = labels[:, 0]

    _, cmc_hits = _rank_from_topk(labels, probe_labels, max_rank)
    correct = (top_label == probe_labels) & mated
    rank1 = float(correct[mated].mean()) if mated.any() else 0.0
    cmc = cmc_hits[mated].mean(axis=0) if mated.any() else np.zeros(max_rank)

    tpir = {}
    unmated_scores = np.sort(top_sim[~mated])[::-1]
    for tgt in fpir_targets:
        # accept exactly k = floor(tgt·n) impostors: τ = (k+1)-th largest
        # unmated score, strict '>' acceptance (τ = −inf accepts all when
        # k ≥ n or there are no impostors)
        n_un = len(unmated_scores)
        kk = int(np.floor(tgt * n_un))
        tau = -np.inf if n_un == 0 or kk >= n_un else unmated_scores[kk]
        hit = (top_sim > tau) & correct
        tpir[float(tgt)] = float(hit[mated].mean()) if mated.any() else 0.0
    return IdentificationResult(rank1=rank1, cmc=np.asarray(cmc), tpir_at_fpir=tpir)
