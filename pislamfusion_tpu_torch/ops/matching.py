"""Descriptor matching as dense distance matrices.

Port of pislamfusion_tpu/ops/matching.py:26-92: Hamming distances of
{0,1} bit-planes (ORB) and L2 distances of float descriptors (SIFT), each
as one matrix product (|a|^2 + |b|^2 - 2 a.b; the reference left that
product to XLA, so it stays `torch.matmul` here), then row argmin,
threshold, optional Lowe ratio and cross-check, under an optional window
mask.
"""
from __future__ import annotations

import torch

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


def window_mask(xy_pred, xy_b, radius: float):
    """[N, M] mask: b within `radius` px of a's predicted location."""
    dx = xy_pred[:, 0:1] - xy_b[None, :, 0]
    dy = xy_pred[:, 1:2] - xy_b[None, :, 1]
    return (dx * dx + dy * dy) <= radius * radius
