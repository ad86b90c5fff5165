"""Descriptor matching as dense distance matrices.

Port of pislamfusion_tpu/ops/matching.py: Hamming distances of {0,1}
bit-planes (ORB) and L2 distances of float descriptors (SIFT), each as
one matrix product (|a|^2 + |b|^2 - 2 a.b; the reference left that
product to XLA, so it stays `torch.matmul` here), then row argmin,
threshold, optional Lowe ratio and cross-check, under an optional window
or vocabulary-bucket mask (`match_descriptors` and its windowed,
bucketed and batch variants), and the rotation-histogram filter
(`rotation_consistency_mask`, MatcherBFMultiH.cpp:296-376).
"""
from __future__ import annotations

import torch

from .lie import first_argmax

_BIG = 1e9


def hamming_matrix(a_bits, b_bits):
    """a_bits [N, 256], b_bits [M, 256] in {0,1} -> [N, M] float32. The
    product of 0/1 values is exact in f32 (keep TF32 off on the card)."""
    a = a_bits.to(torch.float32)
    b = b_bits.to(torch.float32)
    ab = a @ b.T
    na = a.sum(-1)
    nb = b.sum(-1)
    return na[:, None] + nb[None, :] - 2.0 * ab


def l2sq_matrix(a, b):
    """a [N, D], b [M, D] float -> [N, M] squared L2 distances, clamped
    at 0 (keep TF32 off on the card: the SIFT threshold is 0.2 on unit
    descriptors)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    ab = a @ b.T
    na = (a * a).sum(-1)
    nb = (b * b).sum(-1)
    return torch.clamp(na[:, None] + nb[None, :] - 2.0 * ab, min=0.0)


def distance_matrix(desc_a, desc_b, kind: str):
    """kind 'orb': Hamming over bit-planes; 'sift': L2, not squared (the
    reference thresholds plain L2 at 0.2)."""
    if kind == "orb":
        return hamming_matrix(desc_a, desc_b)
    if kind == "sift":
        return torch.sqrt(l2sq_matrix(desc_a, desc_b))
    raise ValueError(f"distance kind {kind!r} is not ported")


def _masked(dist, valid_a, valid_b, extra_mask=None):
    m = valid_a[:, None] & valid_b[None, :]
    if extra_mask is not None:
        m = m & extra_mask
    return torch.where(m, dist, torch.full_like(dist, _BIG))


def match(dist, valid_a, valid_b, max_dist: float, ratio: float = 1.0,
          window_mask=None, cross_check: bool = True):
    """Nearest-neighbour matching with cross-check / threshold / ratio.
    dist: [N, M]; returns (idx [N] int32 into b or -1, ok [N] bool).
    Ties resolve to the first index, as in the reference."""
    d = _masked(dist, valid_a, valid_b, window_mask)
    best = torch.argmin(d, 1)
    bd = torch.gather(d, 1, best[:, None])[:, 0]
    ok = bd < max_dist
    rows = torch.arange(d.shape[0], device=d.device)
    if ratio < 1.0:
        d2 = d.clone()
        d2[rows, best] = _BIG
        ok &= bd < ratio * d2.amin(1)
    if cross_check:
        col_best = torch.argmin(d, 0)
        ok &= col_best[best] == rows
    return torch.where(ok, best, torch.full_like(best, -1)).to(
        torch.int32), ok


def window_mask(xy_pred, xy_b, radius):
    """[N, M] mask: b within `radius` px of a's predicted location;
    radius a scalar or per row [N]."""
    dx = xy_pred[:, 0:1] - xy_b[None, :, 0]
    dy = xy_pred[:, 1:2] - xy_b[None, :, 1]
    r = radius[:, None] if isinstance(radius, torch.Tensor) \
        and radius.ndim == 1 else radius
    return (dx * dx + dy * dy) <= r * r


def rotation_consistency_mask(angle_a, angle_b, idx, valid, bins: int = 30,
                              keep: int = 3, consecutive: bool = False):
    """Keep matches whose angle difference falls in the `keep` most popular
    of `bins` bins. consecutive=False keeps the `keep` individually best
    bins (the larger count first, the lower bin among equal counts, as
    `jax.lax.top_k` orders them); consecutive=True keeps the best circular
    run of `keep` adjacent bins (the first best start)."""
    diff = angle_a - torch.where(idx >= 0, angle_b[idx.long()],
                                 torch.zeros_like(angle_a))
    two_pi = 2.0 * torch.pi
    diff = torch.remainder(diff, two_pi)
    bin_idx = torch.clamp((diff * bins / two_pi).to(torch.int32), 0,
                          bins - 1).long()
    hist = torch.zeros(bins, dtype=torch.int64, device=diff.device)
    hist.index_add_(0, bin_idx, valid.to(torch.int64))
    if consecutive:
        runs = sum(torch.roll(hist, -k) for k in range(keep))
        start = first_argmax(runs)
        in_top = torch.remainder(bin_idx - start, bins) < keep
    else:
        top = torch.sort(hist, descending=True, stable=True)[1][:keep]
        in_top = torch.any(bin_idx[:, None] == top[None, :], -1)
    return valid & in_top


def _default_max_dist(kind, max_dist):
    if max_dist is None:
        return 80.0 if kind == "orb" else 0.2
    return float(max_dist)


def match_descriptors(desc_a, valid_a, desc_b, valid_b, kind: str,
                      max_dist: float | None = None, ratio: float = 1.0,
                      window=None, cross_check: bool = True):
    """One-call matcher. kind 'orb' -> Hamming, default threshold 80;
    kind 'sift' -> L2, default 0.2 (the reference's absolute thresholds).
    window: an optional [N, M] candidate mask."""
    dist = distance_matrix(desc_a, desc_b, kind)
    return match(dist, valid_a, valid_b, _default_max_dist(kind, max_dist),
                 float(ratio), window, cross_check)


def match_descriptors_windowed(desc_a, valid_a, xy_pred, desc_b, valid_b,
                               xy_b, radius, kind: str,
                               max_dist: float | None = None,
                               ratio: float = 1.0,
                               cross_check: bool = True):
    """Candidates of a within `radius` px (scalar or per row) of its
    predicted location xy_pred."""
    w = window_mask(xy_pred, xy_b, radius)
    return match_descriptors(desc_a, valid_a, desc_b, valid_b, kind,
                             max_dist, ratio, w, cross_check)


def match_descriptors_bucketed(desc_a, valid_a, nid_a, desc_b, valid_b,
                               nid_b, kind: str,
                               max_dist: float | None = None,
                               ratio: float = 1.0,
                               cross_check: bool = True):
    """BoW-bucketed brute force (MatcherBoW.cpp:186-300): candidates share
    a vocabulary node id (nid_* [N]/[M] int32, -1 = invalid feature),
    as a dense node-equality mask."""
    same = (nid_a[:, None] == nid_b[None, :]) & (nid_a >= 0)[:, None]
    return match_descriptors(desc_a, valid_a, desc_b, valid_b, kind,
                             max_dist, ratio, same, cross_check)


def match_descriptors_batch(desc_a, valid_a, desc_b, valid_b, kind: str,
                            ratio: float = 0.8):
    """Many candidate keyframes against one frame: desc_a [K, Na, D],
    valid_a [K, Na]. Returns (idx [K, Na], ok [K, Na])."""
    outs = [match_descriptors(da, va, desc_b, valid_b, kind, None, ratio)
            for da, va in zip(desc_a, valid_a)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def matches_to_pairs(idx, valid):
    """Dense [N]->[M] assignment to a padded pair list [(ia, ib)] with its
    mask."""
    ia = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    ib = torch.where(valid, idx.to(torch.int32), torch.zeros_like(ia))
    return torch.stack([ia, ib], -1), valid
