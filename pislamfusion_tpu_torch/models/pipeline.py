"""The tracker's per-frame device steps.

Port of the parts of pislamfusion_tpu/models/pipeline.py that offline SLAM
calls (the reference's per-frame hot path, SURVEY.md section 3.2: extract,
windowed match against the last frame, pose-only LM, then trackLocalMap):

  * `fused_extract` - a frame (gray or RGB, any dtype) -> its padded
    features (`_detect`: ORB or SIFT, by the params' type);
  * `fused_frame_step` / `_frame_step_core` - windowed match of the
    previous frame's map points against the new features, pose-only LM
    (TrackerOpt::trackLastFrame, :636-793);
  * `fused_localmap_step` / `_localmap_core` - project the padded local map
    into the refined pose, windowed re-match, merged pose-only LM
    (TrackerOpt::trackLocalMap, :1107-1305);
  * `fused_track_packed_feats` / `_track_core` - both, with the results
    packed into ONE [16 + 6N + 2P] float32 tensor, so the host reads one
    buffer (one synchronisation) a frame.

  * `fused_track_chain` / `fused_track_chain_images` - K consecutive
    frames through `_track_core` with the per-frame carry (last frame's
    descriptors, point bindings, pose estimate and motion model) kept on
    the device, their rows stacked into ONE [K, 16 + 6N + 2P] tensor: the
    online `SLAM.TrackChain` mode reads one buffer a chain.

Nothing here reads back to the host: on the card these functions only
enqueue work. `models/fastvo.py` runs its frames through the same
`_detect` and `match_to_slots`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import ba, image as im, lie, matching
from ..ops.features import orb, sift


def _mark(mark, stage: str):
    if mark is not None:
        mark(stage)


def _detect(gray, params, pyramid: str = "flat", mark=None):
    """Features of one gray frame [H, W] float32: ORB for `orb.OrbParams`
    (its front end by `pyramid`, "flat" K1 or "packed" K7), SIFT for
    `sift.SiftParams`, in the detector's three stages; `mark(stage)` as
    each is enqueued."""
    if isinstance(params, sift.SiftParams):
        stacks = sift.build_stacks(gray, params)
        _mark(mark, "octave_stacks")
        picks = sift.select_octaves(stacks, params)
        _mark(mark, "extrema_select")
        feats = sift.describe(stacks, picks, tuple(gray.shape), params)
        _mark(mark, "orient_desc")
        return feats
    packed, views, offs = orb.build_pyramid(gray, params, pyramid)
    _mark(mark, "pyramid")
    picks = orb.select_levels(packed, views, offs, params)
    _mark(mark, "fast_nms_select")
    feats = orb.descriptor_tail(picks, packed, offs, params)
    _mark(mark, "descriptor_tail")
    return feats


def _desc_kind(desc) -> str:
    """Descriptor family from the tensor itself: ORB bit-planes are uint8,
    SIFT 128-vectors are float32."""
    return "orb" if desc.dtype == torch.uint8 else "sift"


def _desc_max_dist(kind: str) -> float:
    """Reference absolute thresholds: Hamming 80 (MatcherBoW.cpp:133-174),
    RootSIFT L2 0.2."""
    return 80.0 if kind == "orb" else 0.2


def fused_extract(image, params=orb.OrbParams(), pyramid: str = "flat"):
    """Feature extraction alone. image: [H, W] gray or [H, W, 3] RGB
    tensor, any dtype (the gray conversion and the float cast run on the
    image's device, so the host uploads the raw uint8 frame)."""
    image = image.to(torch.float32)
    if image.ndim == 3:
        image = im.rgb_to_gray(image)
    return _detect(image, params, pyramid)


class FrameStepResult(NamedTuple):
    T_w2c: torch.Tensor       # [7] refined pose (world->camera)
    n_inliers: torch.Tensor   # scalar int
    idx: torch.Tensor         # [N] prev-slot -> cur-slot match index
    ok: torch.Tensor          # [N] prev-slot match validity
    chi2: torch.Tensor        # [N] per-CUR-slot squared residual
    weight: torch.Tensor      # [N] per-CUR-slot weight used in the LM
    feats: dict               # the new frame's features


def project(T_w2c, p3d, fx, fy, cx, cy):
    """Pinhole projection of world points p3d [P, 3] through T_w2c [7]:
    (pixels [P, 2], in front of the camera [P] bool)."""
    pc = lie.se3_apply(T_w2c.expand(p3d.shape[0], 7), p3d)
    z = torch.clamp(pc[:, 2], min=1e-6)
    pix = torch.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], -1)
    return pix, pc[:, 2] > 1e-3


def match_to_slots(pix, src_desc, src_mask, src_p3d, feats, radius,
                   window_mask=None):
    """Windowed match of source points (predicted pixels pix [P, 2],
    descriptors, mask [P], world points [P, 3]) against a frame's features
    within `radius` px, and the matched points scattered onto the frame's
    keypoint slots. Returns (idx [P], ok [P], p3d [N, 3], w [N])."""
    if window_mask is None:
        window_mask = matching.window_mask(pix, feats["xy"], radius)
    kind = _desc_kind(src_desc)
    dist = matching.distance_matrix(src_desc, feats["desc"], kind)
    idx, ok = matching.match(dist, src_mask, feats["valid"],
                             max_dist=_desc_max_dist(kind),
                             window_mask=window_mask)
    n = feats["xy"].shape[0]
    return idx, ok, _to_slots(src_p3d, idx, ok, n), _to_slots(
        ok.to(src_p3d.dtype), idx, ok, n)


def _to_slots(src, idx, ok, n: int):
    """src rows [P, ...] moved to the frame's slots idx where ok, zeros
    elsewhere: [n, ...]. Matches are one-to-one, so no two kept rows
    collide; the rest land in a dropped row n (`index_copy_`: a plain
    copy kernel, where an `index_put_` with those repeated indices takes
    the card's sorting path)."""
    tgt = torch.where(ok, idx.to(torch.int64), n)
    out = src.new_zeros((n + 1,) + tuple(src.shape[1:]))
    return out.index_copy_(0, tgt, src)[:n]


def _rays_xy(xy, fx, fy, cx, cy):
    return torch.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy], -1)


def _frame_step_core(feats, prev_desc, prev_valid, prev_p3d, prev_has,
                     T_pred_w2c, fx, fy, cx, cy, radius, chi2_th):
    """Match-vs-last + pose LM given already-extracted features."""
    pix, infront = project(T_pred_w2c, prev_p3d, fx, fy, cx, cy)
    idx, ok, p3d, w = match_to_slots(pix, prev_desc,
                                     prev_valid & prev_has & infront,
                                     prev_p3d, feats, radius)
    T, _, chi2 = ba.optimize_pose(
        T_pred_w2c, p3d, _rays_xy(feats["xy"], fx, fy, cx, cy), w,
        iters=10, huber_delta=math.sqrt(chi2_th) / fx)
    inl = torch.sum((w > 0) & (chi2 < chi2_th / fx ** 2))
    return FrameStepResult(T, inl, idx, ok, chi2, w, feats)


def fused_frame_step(image, prev_desc, prev_valid, prev_p3d, prev_has,
                     T_pred_w2c, params=orb.OrbParams(), fx: float = 260.0,
                     fy: float = 260.0, cx: float = 160.0, cy: float = 120.0,
                     radius: float = 20.0,
                     chi2_th: float = 5.991) -> FrameStepResult:
    """image: [H, W] gray or [H, W, 3] RGB tensor, any dtype. prev_*: the
    previous frame's padded features and the world positions of their map
    points (prev_has marks tracked slots). T_pred_w2c: [7] motion-model
    prediction (world->camera)."""
    feats = fused_extract(image, params)
    return _frame_step_core(feats, prev_desc, prev_valid, prev_p3d,
                            prev_has, T_pred_w2c, fx, fy, cx, cy, radius,
                            chi2_th)


class LocalMapStepResult(NamedTuple):
    T_w2c: torch.Tensor       # [7] refined pose
    n_inliers: torch.Tensor   # scalar int
    idx: torch.Tensor         # [P] local-point -> cur-slot match index
    ok: torch.Tensor          # [P]
    chi2: torch.Tensor        # [N] per-CUR-slot squared residual
    weight: torch.Tensor      # [N] per-CUR-slot weight (existing + new)


def _localmap_core(desc, valid, xy, T_w2c, p3d_cur, w_cur,
                   local_pos, local_desc, local_valid,
                   fx, fy, cx, cy, width, height, radius, chi2_th):
    """fused_localmap_step that ALSO returns the merged per-slot (p3d, w)
    bindings."""
    pix, infront = project(T_w2c, local_pos, fx, fy, cx, cy)
    inview = ((pix[:, 0] >= 0) & (pix[:, 0] < width)
              & (pix[:, 1] >= 0) & (pix[:, 1] < height))
    feats = {"desc": desc, "valid": valid, "xy": xy}
    idx, ok, p3d_new, w_new = match_to_slots(
        pix, local_desc, local_valid & infront & inview, local_pos, feats,
        radius)
    # new bindings only where the slot is still free
    free = w_cur <= 0
    p3d = torch.where(free[:, None], p3d_new, p3d_cur)
    w = torch.where(free, w_new, w_cur)
    T, _, chi2 = ba.optimize_pose(
        T_w2c, p3d, _rays_xy(xy, fx, fy, cx, cy), w, iters=10,
        huber_delta=math.sqrt(chi2_th) / fx)
    inl = torch.sum((w > 0) & (chi2 < chi2_th / fx ** 2))
    return LocalMapStepResult(T, inl, idx, ok, chi2, w), p3d, w


def fused_localmap_step(desc, valid, xy, T_w2c, p3d_cur, w_cur,
                        local_pos, local_desc, local_valid,
                        fx: float, fy: float, cx: float, cy: float,
                        width: int, height: int, radius: float = 8.0,
                        chi2_th: float = 5.991) -> LocalMapStepResult:
    """desc/valid/xy: current frame's padded features. p3d_cur/w_cur: 3D
    points already bound to current keypoint slots (from the last-frame
    step). local_*: padded local-map point cloud + descriptors."""
    res, _, _ = _localmap_core(desc, valid, xy, T_w2c, p3d_cur, w_cur,
                               local_pos, local_desc, local_valid,
                               fx, fy, cx, cy, width, height, radius,
                               chi2_th)
    return res


def _track_steps(feats, prev_desc, prev_valid, prev_p3d, prev_has,
                 T_pred_w2c, local_pos, local_desc, local_valid,
                 fx, fy, cx, cy, width, height, radius, radius_local,
                 chi2_th):
    """Match-vs-last + pose LM, then the local-map re-match + merged LM.
    Returns (FrameStepResult, LocalMapStepResult, merged p3d, merged w)."""
    res = _frame_step_core(feats, prev_desc, prev_valid, prev_p3d,
                           prev_has, T_pred_w2c, fx, fy, cx, cy, radius,
                           chi2_th)
    # the first LM's bindings, without those it rejected
    w_cur = torch.where(res.chi2 < chi2_th / fx ** 2, res.weight, 0.0)
    p3d_cur = _to_slots(prev_p3d, res.idx, res.ok, feats["xy"].shape[0])
    res2, p3d_m, w_m = _localmap_core(
        feats["desc"], feats["valid"], feats["xy"], res.T_w2c,
        p3d_cur, w_cur, local_pos, local_desc, local_valid,
        fx, fy, cx, cy, width, height, radius_local, chi2_th)
    return res, res2, p3d_m, w_m


def _pack(res, res2):
    f32 = torch.float32
    return torch.cat([
        res.T_w2c, res.n_inliers[None].to(f32),
        res2.T_w2c, res2.n_inliers[None].to(f32),
        res.idx.to(f32), res.ok.to(f32),
        res.chi2, res.weight, res2.chi2, res2.weight,
        res2.idx.to(f32), res2.ok.to(f32)])


def _track_core(feats, prev_desc, prev_valid, prev_p3d, prev_has,
                T_pred_w2c, local_pos, local_desc, local_valid,
                fx, fy, cx, cy, width, height, radius, radius_local,
                chi2_th):
    """The per-frame track body (`_track_steps`) packed into one row
    (layout: `fused_track_packed_feats`). Also returns the merged per-slot
    (p3d, w) bindings and the local-map step's result."""
    res, res2, p3d_m, w_m = _track_steps(
        feats, prev_desc, prev_valid, prev_p3d, prev_has, T_pred_w2c,
        local_pos, local_desc, local_valid, fx, fy, cx, cy, width, height,
        radius, radius_local, chi2_th)
    return _pack(res, res2), p3d_m, w_m, res2


def fused_track_step(image, prev_desc, prev_valid, prev_p3d, prev_has,
                     T_pred_w2c, local_pos, local_desc, local_valid,
                     params=orb.OrbParams(), fx: float = 260.0,
                     fy: float = 260.0, cx: float = 160.0, cy: float = 120.0,
                     width: int = 320, height: int = 240,
                     radius: float = 20.0, radius_local: float = 8.0,
                     chi2_th: float = 5.991):
    """The whole per-frame tracking path from the image: extract ->
    match-vs-last -> pose LM -> project local map -> re-match -> merged
    pose LM. Returns (FrameStepResult, LocalMapStepResult)."""
    feats = fused_extract(image, params)
    res, res2, _, _ = _track_steps(
        feats, prev_desc, prev_valid, prev_p3d, prev_has, T_pred_w2c,
        local_pos, local_desc, local_valid, fx, fy, cx, cy, width, height,
        radius, radius_local, chi2_th)
    return res, res2


def fused_track_packed(image, prev_desc, prev_valid, prev_p3d, prev_has,
                       T_pred_w2c, local_pos, local_desc, local_valid,
                       params=orb.OrbParams(), fx: float = 260.0,
                       fy: float = 260.0, cx: float = 160.0,
                       cy: float = 120.0, width: int = 320,
                       height: int = 240, radius: float = 20.0,
                       radius_local: float = 8.0, chi2_th: float = 5.991):
    """fused_track_step with its results packed into one tensor (the
    layout of `fused_track_packed_feats`). Returns (feats, packed)."""
    feats = fused_extract(image, params)
    packed, _, _, _ = _track_core(
        feats, prev_desc, prev_valid, prev_p3d, prev_has, T_pred_w2c,
        local_pos, local_desc, local_valid, fx, fy, cx, cy, width, height,
        radius, radius_local, chi2_th)
    return feats, packed


def fused_track_packed_feats(feats, prev_desc, prev_valid, aux,
                             local_pos, local_desc, local_valid,
                             fx: float = 260.0, fy: float = 260.0,
                             cx: float = 160.0, cy: float = 120.0,
                             width: int = 320, height: int = 240,
                             radius: float = 20.0, radius_local: float = 8.0,
                             chi2_th: float = 5.991):
    """The per-frame track of a frame whose features are already on the
    device. The small per-frame host inputs ride in ONE packed `aux`
    tensor (one upload):

      aux [4N + 7] f32 = [prev_p3d.ravel (3N), prev_has (N), T_pred (7)]

    Returns packed [16 + 6N + 2P] f32:
      packed[:16]          = [T1(7), n_inl1, T2(7), n_inl2]
      packed[16:16+6N]     = [idx1, ok1, chi2_1, w1, chi2_2, w2] (per kp)
      packed[16+6N:]       = [idx2, ok2]            (per local-map point)
    """
    n = prev_desc.shape[0]
    prev_p3d = aux[:3 * n].reshape(n, 3)
    prev_has = aux[3 * n:4 * n] > 0.5
    T_pred_w2c = aux[4 * n:4 * n + 7]
    packed, _, _, _ = _track_core(
        feats, prev_desc, prev_valid, prev_p3d, prev_has, T_pred_w2c,
        local_pos, local_desc, local_valid, fx, fy, cx, cy, width, height,
        radius, radius_local, chi2_th)
    return packed


def _chain_carry(aux, n: int):
    """The chain's host inputs, one packed `aux` [4N + 14] f32 =
    [prev_p3d.ravel (3N), prev_has (N), pose_est_c2w (7), motion (7)]:
    (p3d [N, 3], has [N], pose_est, motion)."""
    return (aux[:3 * n].reshape(n, 3), aux[3 * n:4 * n] > 0.5,
            aux[4 * n:4 * n + 7], aux[4 * n + 7:4 * n + 14])


def _chain_step(feats, carry, local_pos, local_desc, local_valid, fx, fy,
                cx, cy, width, height, radius, radius_local, chi2_th):
    """One chain step: the motion-model prediction, `_track_core`, and the
    next carry, as the host tracker would rebuild it from the row (the
    merged bindings that stay inliers, the refined pose, the motion
    inv(pose_est) o pose_new). Returns (row, next carry)."""
    p_desc, p_valid, p_p3d, p_has, pose_est, motion = carry
    T_pred_w2c = lie.se3_inv(lie.se3_mul(pose_est, motion))
    packed, p3d_m, w_m, res2 = _track_core(
        feats, p_desc, p_valid, p_p3d, p_has, T_pred_w2c, local_pos,
        local_desc, local_valid, fx, fy, cx, cy, width, height, radius,
        radius_local, chi2_th)
    pose_new = lie.se3_inv(res2.T_w2c)
    has_m = (w_m > 0) & (res2.chi2 < chi2_th / fx ** 2)
    motion_new = lie.se3_mul(lie.se3_inv(pose_est), pose_new)
    return packed, (feats["desc"], feats["valid"], p3d_m, has_m, pose_new,
                    motion_new)


def fused_track_chain(desc_k, valid_k, xy_k, prev_desc, prev_valid, aux,
                      local_pos, local_desc, local_valid,
                      fx: float = 260.0, fy: float = 260.0,
                      cx: float = 160.0, cy: float = 120.0,
                      width: int = 320, height: int = 240,
                      radius: float = 20.0, radius_local: float = 8.0,
                      chi2_th: float = 5.991):
    """Track K consecutive frames with the per-frame carry kept ON THE
    DEVICE, so the host reads ONE packed buffer for the K frames (the
    JAX package's lax.scan is a Python loop over device tensors here: it
    enqueues K steps and reads nothing back).

    The local-map stage is FIXED across the chain, the same one-stage
    staleness the online mapper already imposes on the per-frame path.

    desc_k/valid_k/xy_k: the K frames' padded features, stacked on the
    leading axis. aux [4N + 14] f32 = [prev_p3d.ravel (3N), prev_has (N),
    pose_est_c2w (7), motion (7)]: the host tracker's camera-frame motion
    model, pose_pred = pose_est o motion, re-estimated after each step as
    Tracker.track does on the host (motion' = inv(pose_est) o pose_new).

    Exactly K steps run. The JAX package pads K to a power of two only to
    bound its number of compiled programs; eager PyTorch compiles nothing,
    so a step past the last frame would be work and no more.

    Returns packed [K, 16 + 6N + 2P], `fused_track_packed_feats` rows.
    Rows after a failure inside the chain are garbage (the carry went
    bad): the host sees the failure in the row's own inlier fields and
    tracks the tail again frame by frame."""
    n = prev_desc.shape[0]
    carry = (prev_desc, prev_valid) + _chain_carry(aux, n)
    rows = []
    for k in range(desc_k.shape[0]):
        feats = {"desc": desc_k[k], "valid": valid_k[k], "xy": xy_k[k]}
        row, carry = _chain_step(feats, carry, local_pos, local_desc,
                                 local_valid, fx, fy, cx, cy, width, height,
                                 radius, radius_local, chi2_th)
        rows.append(row)
    return torch.stack(rows)


def fused_track_chain_images(images_k, prev_desc, prev_valid, aux,
                             local_pos, local_desc, local_valid,
                             params=orb.OrbParams(), pyramid: str = "flat",
                             fx: float = 260.0, fy: float = 260.0,
                             cx: float = 160.0, cy: float = 120.0,
                             width: int = 320, height: int = 240,
                             radius: float = 20.0, radius_local: float = 8.0,
                             chi2_th: float = 5.991):
    """`fused_track_chain` fed the raw frames: each step converts its frame
    to gray float and extracts its features (`_detect`: K1, K4, K2 for
    ORB; K5, K6 for SIFT) before it tracks, so the host uploads the K
    frames in ONE copy. images_k: [K, H, W] gray or [K, H, W, 3] RGB, any
    dtype, on the device. aux as in `fused_track_chain`; exactly K steps
    (see there).

    Returns (packed_k [K, rows], feats_k: each frame's padded features
    stacked on axis 0, left on the device for the host to slice into the
    Frames it tracked)."""
    n = prev_desc.shape[0]
    carry = (prev_desc, prev_valid) + _chain_carry(aux, n)
    rows, feats_all = [], []
    for k in range(images_k.shape[0]):
        feats = fused_extract(images_k[k], params, pyramid)
        row, carry = _chain_step(feats, carry, local_pos, local_desc,
                                 local_valid, fx, fy, cx, cy, width, height,
                                 radius, radius_local, chi2_th)
        rows.append(row)
        feats_all.append(feats)
    return torch.stack(rows), {key: torch.stack([f[key] for f in feats_all])
                               for key in feats_all[0]}
