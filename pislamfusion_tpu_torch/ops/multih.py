"""Multi-homography match growth — the reference's default Matcher.

Port of pislamfusion_tpu/ops/multih.py (MatcherMultiH.cpp:197-450 and
MatcherBFMultiH.cpp:296-490): a cross-checked brute-force match, up to K
homographies peeled off its survivors by RANSAC, then the still-free
keypoints re-matched inside windows around each homography's prediction.

Randomness: each homography RANSAC samples over the matches that earlier
planes left, so its indices depend on the data. The public functions take
the reference's key (`threefry.Key`) and split it as the reference splits
its JAX key; their `_..._from_noise` variants take the Gumbel
noise each RANSAC draws ([n_h, iters, Na]; `match_bf_multih` also the F
sweep's [iters, Na]), from which every sample is the top-k of the noise
over the points still valid, as the reference's `_sample_indices` does.
"""
from __future__ import annotations

import torch

from . import matching, ransac, threefry


def _apply_h(H, xy):
    """[3,3] x [N,2] -> [N,2] projective transform."""
    d = xy @ H[:, :2].T + H[:, 2]
    return d[:, :2] / torch.where(torch.abs(d[:, 2:]) < 1e-9, 1e-9,
                                  d[:, 2:])


def _taken(ok, idx, n_b):
    """[n_b] bool: b keypoints the matches (idx, ok) already took."""
    taken = torch.zeros(n_b + 1, dtype=torch.bool, device=idx.device)
    taken[torch.where(ok, idx.long(), n_b)] = True
    return taken[:n_b]


def _match_multih_from_noise(noise, desc_a, valid_a, xy_a, desc_b, valid_b,
                             xy_b, kind: str = "orb", window: float = 8.0,
                             max_dist: float | None = None,
                             h_threshold: float = 3.0, ratio: float = 0.8,
                             base_mask=None):
    """`match_multih` on drawn Gumbel noise [n_h, iters, Na]."""
    dist = matching.distance_matrix(desc_a, desc_b, kind)
    max_dist = matching._default_max_dist(kind, max_dist)
    idx, ok = matching.match(dist, valid_a, valid_b, max_dist, ratio=ratio,
                             window_mask=base_mask)
    pb = xy_b[torch.where(ok, idx, 0).long()]
    remaining = ok
    grow_mask = torch.zeros((xy_a.shape[0], xy_b.shape[0]), dtype=torch.bool,
                            device=xy_a.device)
    n_planes = torch.zeros((), dtype=torch.int32, device=xy_a.device)
    for g in noise:
        res = ransac._find_homography_from_samples(
            ransac.top_k_indices(g, remaining, 4).to(xy_a.device), xy_a, pb,
            remaining, threshold=h_threshold)
        good = res.ok & (res.score >= 12)
        n_planes = n_planes + good.to(torch.int32)
        # peel this plane's inliers and fit the next on the rest
        remaining = remaining & ~(res.inliers & good)
        # growth: union of the planes' windows around each H's prediction
        grow_mask |= matching.window_mask(_apply_h(res.model, xy_a), xy_b,
                                          window) & good
    free_a = valid_a & ~ok
    # b keypoints already taken by the base match are excluded
    taken_b = _taken(ok, idx, xy_b.shape[0])
    idx2, ok2 = matching.match(dist, free_a, valid_b & ~taken_b, max_dist,
                               window_mask=grow_mask)
    return torch.where(ok, idx, idx2), ok | ok2, n_planes


def _plane_noise(key: threefry.Key, n_h, iters, n):
    """Gumbel noise [n_h, iters, n] for n_h homography RANSACs: one split
    key a plane, as the reference draws."""
    return torch.stack([k.gumbel((iters, n)) for k in key.split(n_h)])


def match_multih(key: threefry.Key, desc_a, valid_a, xy_a, desc_b, valid_b,
                 xy_b, kind: str = "orb", n_h: int = 4, window: float = 8.0,
                 max_dist: float | None = None, h_threshold: float = 3.0,
                 ransac_iters: int = 192, ratio: float = 0.8,
                 base_mask=None):
    """Returns (idx [Na] a->b match index, ok [Na], n_planes): the base
    ratio+cross-checked BF matches grown by up to n_h homography-guided
    window re-matches (MatcherMultiH.cpp:197-450; the growth pass uses the
    absolute threshold alone, findMatchWindow :129-168). base_mask [Na, Nb]
    (optional) restricts the base match's candidates (a vocabulary
    node-equality mask gives the reference's `bowH` matcher)."""
    noise = _plane_noise(key, n_h, ransac_iters, xy_a.shape[0])
    return _match_multih_from_noise(noise, desc_a, valid_a, xy_a, desc_b,
                                    valid_b, xy_b, kind, window, max_dist,
                                    h_threshold, ratio, base_mask)


def _match_bf_multih_from_noise(noise_f, noise_h, desc_a, valid_a, xy_a,
                                angle_a, desc_b, valid_b, xy_b, angle_b,
                                kind: str = "orb", window: float = 8.0,
                                max_dist: float | None = None,
                                bins: int = 30, keep: int = 3,
                                f_threshold: float = 2.0,
                                h_threshold: float = 3.0):
    """`match_bf_multih` on drawn Gumbel noise: noise_f [iters, Na] for F,
    noise_h [n_h, iters, Na] for the homographies."""
    dist = matching.distance_matrix(desc_a, desc_b, kind)
    max_dist = matching._default_max_dist(kind, max_dist)
    idx, ok = matching.match(dist, valid_a, valid_b, max_dist)
    ok = matching.rotation_consistency_mask(angle_a, angle_b, idx, ok,
                                            bins=bins, keep=keep,
                                            consecutive=True)
    pb = xy_b[torch.where(ok, idx, 0).long()]
    fres = ransac._find_fundamental_from_samples(
        ransac.top_k_indices(noise_f, ok, 8).to(xy_a.device), xy_a, pb, ok,
        threshold=f_threshold)
    # prune to F-inliers when F was found (reference: "reduce")
    ok = torch.where(fres.ok, ok & fres.inliers, ok)
    remaining = ok
    preds, errs = [], []
    n_planes = torch.zeros((), dtype=torch.int32, device=xy_a.device)
    for g in noise_h:
        res = ransac._find_homography_from_samples(
            ransac.top_k_indices(g, remaining, 4).to(xy_a.device), xy_a, pb,
            remaining, threshold=h_threshold)
        good = fres.ok & res.ok & (res.score >= 12)
        n_planes = n_planes + good.to(torch.int32)
        remaining = remaining & ~(res.inliers & good)
        pred = _apply_h(res.model, xy_a)
        preds.append(pred)
        errs.append(torch.where(
            good, ransac._f_epipolar_err(fres.model, xy_a, pred), torch.inf))
    # guided growth: the best H per free keypoint by epipolar distance
    preds = torch.stack(preds)                   # [K, Na, 2]
    errs = torch.stack(errs)                     # [K, Na]
    best_err = errs.min(0).values
    # the first plane of the smallest distance (jnp.argmin's rule)
    k_idx = torch.arange(errs.shape[0], device=errs.device)[:, None]
    best_j = torch.where(errs == best_err, k_idx, errs.shape[0]).min(0).values
    best_j = torch.where(torch.isnan(best_err), 0, best_j).clamp(
        max=errs.shape[0] - 1)
    best_pred = torch.gather(preds, 0, best_j[None, :, None].expand(
        1, -1, 2))[0]
    # symmetric squared distance gate at 2 * f_threshold^2
    near_f = best_err < 2.0 * f_threshold ** 2
    grow_mask = matching.window_mask(best_pred, xy_b, window) \
        & near_f[:, None]
    free_a = valid_a & ~ok
    taken_b = _taken(ok, idx, xy_b.shape[0])
    # best-in-window without the reverse check (findMatchWindow: only
    # forward uniqueness is enforced)
    idx2, ok2 = matching.match(dist, free_a, valid_b & ~taken_b, max_dist,
                               window_mask=grow_mask, cross_check=False)
    return torch.where(ok, idx, idx2), ok | ok2, n_planes


def match_bf_multih(key: threefry.Key, desc_a, valid_a, xy_a, angle_a,
                    desc_b, valid_b, xy_b, angle_b,
                    kind: str = "orb", n_h: int = 5, window: float = 8.0,
                    max_dist: float | None = None, bins: int = 30,
                    keep: int = 3, f_threshold: float = 2.0,
                    h_threshold: float = 3.0, ransac_iters: int = 192):
    """The reference's other multi-H matcher (MatcherBFMultiH.cpp:296-490):
    cross-checked BF match, the rotation-histogram vote (best circular run
    of `keep` of `bins`), an F RANSAC prune, up to n_h homographies peeled
    from the F-inliers, and a guided re-match through the H whose
    prediction lies nearest F's epipolar line. Returns (idx [Na], ok [Na],
    n_planes)."""
    n = xy_a.shape[0]
    k_f, k_h = key.split()              # as the reference splits its key
    noise_f = k_f.gumbel((ransac_iters, n))
    noise_h = _plane_noise(k_h, n_h, ransac_iters, n)
    return _match_bf_multih_from_noise(
        noise_f, noise_h, desc_a, valid_a, xy_a, angle_a, desc_b, valid_b,
        xy_b, angle_b, kind, window, max_dist, bins, keep, f_threshold,
        h_threshold)
