"""Segment-parallel survey processing: FastVO scaled over a device mesh.

Port of pislamfusion_tpu/parallel/dist_vo.py:30-313. The per-frame VO
chain is sequential (pose t needs pose t-1), but a survey splits into
SEGMENTS anchored by GPS or a coarse first pass, and segments are
independent: shard i takes a contiguous block of segments and runs each
one's track+fuse chain (`FastVO._detect` -> `_track_core` -> `_feed`) on
its device into a fresh canvas pyramid; the canvases merge by max weight
at the end, the first segment winning a tie (`jnp.argmax`'s rule).

The reference vmaps the segments and stacks their canvases; here each
shard keeps one running merge (a segment's canvas replaces the merge
where its weight is strictly greater), so a shard holds two canvases at
a time, and the shards' merges are merged in shard order on the first
device: the same pixels win. Nothing in the segment loop reads back to
the host; the poses and match counts come back in one fetch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import lie
from ..ops import mosaic as M
from .mesh import Mesh, blocks, on


def _frame(f, device):
    return f.to(device, torch.float32)


def _initial(vo, frame0, anchor):
    """The track carry at a segment's first frame (the motion model at
    rest) and its feature count."""
    f0 = vo._detect(frame0)
    p3d0 = vo._plane_points(f0["xy"], anchor)
    n0 = f0["valid"].sum().to(torch.float32)
    return (f0["desc"], f0["valid"], p3d0, anchor, anchor), n0


def _fresh_canvas(vo, device):
    return M.alloc_canvas(vo.canvas_tiles, vo.canvas_tiles, vo.bands,
                          device)


def _segment_program(vo, frames_k, anchor):
    """One segment's track+fuse chain on a fresh canvas. Returns (poses
    [K, 7], n_match [K] float, canvas)."""
    d = anchor.device
    canvas = _fresh_canvas(vo, d)
    carry, n0 = _initial(vo, _frame(frames_k[0], d), anchor)
    vo._feed(anchor, _frame(frames_k[0], d), canvas)
    poses, nms = [anchor], [n0]
    for k in range(1, frames_k.shape[0]):
        carry, (pose, n) = vo._step(carry, _frame(frames_k[k], d),
                                    canvas=canvas)
        poses.append(pose)
        nms.append(n.to(torch.float32))
    return torch.stack(poses), torch.stack(nms), canvas


def _segment_track(vo, frames_k, anchor):
    """Track-only chain of one segment (no compositing) -> poses, n_match."""
    d = anchor.device
    carry, n0 = _initial(vo, _frame(frames_k[0], d), anchor)
    poses, nms = [anchor], [n0]
    for k in range(1, frames_k.shape[0]):
        carry, (pose, n) = vo._track_core(
            carry, vo._detect(_frame(frames_k[k], d)))
        poses.append(pose)
        nms.append(n.to(torch.float32))
    return torch.stack(poses), torch.stack(nms)


def _segment_feed(vo, frames_k, poses_k):
    """Feed-only chain: composite each frame at the given (corrected)
    pose into a fresh canvas pyramid."""
    d = poses_k.device
    canvas = _fresh_canvas(vo, d)
    for k in range(frames_k.shape[0]):
        vo._feed(poses_k[k], _frame(frames_k[k], d), canvas)
    return canvas


def _bend(poses, anchor_next, stride: int, has_next: bool):
    """Distribute the endpoint error err = anchor_next * inv(pose[stride])
    along the chain in se3 log space: pose_i' = exp(clip(i / stride, 0, 1)
    * log(err)) * pose_i (the reference's pose-graph endpoint relaxation,
    dist_vo.py:103-141). A segment with no next anchor bends by zero."""
    err = lie.se3_mul(anchor_next, lie.se3_inv(poses[stride]))
    xi = lie.se3_log(err)
    if not has_next:
        xi = torch.zeros_like(xi)
    K = poses.shape[0]
    t = torch.clamp(torch.arange(K, dtype=torch.float32,
                                 device=poses.device) / float(stride),
                    0.0, 1.0)
    corr = lie.se3_exp(t[:, None] * xi[None, :])
    return lie.se3_mul(corr, poses)


def _merge_into(merged, canvas):
    """Max-weight merge, in place into `merged` (lap bands, weight bands):
    per band, each pixel takes `canvas` where its weight is strictly
    greater, so of equal weights the earlier canvas stays (the reference's
    argmax rule)."""
    d = merged[0][0].device
    for ml, mw, cl, cw in zip(merged[0], merged[1], canvas[0], canvas[1]):
        cl, cw = cl.to(d), cw.to(d)
        take = cw[..., :1] > mw[..., :1]
        ml.copy_(torch.where(take, cl, ml))
        mw.copy_(torch.where(take, cw, mw))
    return merged


def process_survey(vo, frames, anchors, mesh: Mesh | None = None,
                   correct_drift: bool = False,
                   anchor_stride: int | None = None):
    """Track+fuse S segments in parallel over the mesh.

    vo: a FastVO configured for the survey's canvas geometry.
    frames: [S, K, H, W(,3)]; anchors: [S, 7] pose of each segment's first
    frame in plane coordinates (GPS-derived or from a coarse pass).
    Returns (poses [S, K, 7], n_match [S, K]) as numpy and REPLACES vo's
    canvas with the merged mosaic (so vo.blended() works as usual).

    Ragged S is fine: shard i takes the i-th of the contiguous blocks of
    ceil(S / D) segments (D = mesh size), so the last shards may hold
    fewer or none. Without a mesh every segment runs on vo's device.

    correct_drift=True runs the two-pass variant: track-only chains, each
    bent onto the NEXT segment's anchor (see `_bend`), then feed-only
    chains at the corrected poses. Requires overlapped segmentation
    (segments_from_frames(overlap>=1)) and anchor_stride = seg_len -
    overlap (the frame count between anchors).
    """
    frames = torch.as_tensor(frames)
    anchors = torch.as_tensor(anchors, dtype=torch.float32)
    S, K = frames.shape[0], frames.shape[1]
    if correct_drift:
        if anchor_stride is None or not (0 < anchor_stride < K):
            raise ValueError(
                "correct_drift needs anchor_stride = seg_len - overlap in "
                "[1, K): segment s's frame at that index must be segment "
                "s+1's anchored first frame (use segments_from_frames with "
                "overlap >= 1)")
    shard_devs = [vo.device] if mesh is None else mesh.flat
    out_dev = shard_devs[0]
    poses_all, nm_all, merges = [], [], []
    # contiguous blocks of segments, one a shard; where S does not divide,
    # the last shards hold fewer (the reference pads them with weight-0
    # copies of segment 0, which no merge takes and whose poses it drops)
    for d, (a, b) in zip(shard_devs, blocks(S, len(shard_devs))):
        merged = None
        with on(d):
            for s in range(a, b):
                fr = frames[s].to(d)
                anchor = anchors[s].to(d)
                if correct_drift:
                    poses, nms = _segment_track(vo, fr, anchor)
                    nxt = anchors[min(s + 1, S - 1)].to(d)
                    poses = _bend(poses, nxt, int(anchor_stride), s < S - 1)
                    canvas = _segment_feed(vo, fr, poses)
                else:
                    poses, nms, canvas = _segment_program(vo, fr, anchor)
                poses_all.append(poses.to(out_dev))
                nm_all.append(nms.to(out_dev))
                if merged is None:
                    merged = canvas     # the shard's first segment
                else:
                    _merge_into(merged, canvas)
        if merged is not None:
            merges.append(merged)
    # the shards' merges, in shard order, on the first device
    with on(out_dev):
        total = merges[0]
        for m in merges[1:]:
            _merge_into(total, m)
        for i, (lap, w) in enumerate(zip(*total)):
            setattr(vo, f"canvas_lap_{i}", lap.to(vo.device))
            setattr(vo, f"canvas_w_{i}", w.to(vo.device))
        packed = torch.cat([torch.stack(poses_all),
                            torch.stack(nm_all)[..., None]], -1)
    out = packed.cpu().numpy()                # one fetch
    return out[..., :7], out[..., 7].astype(np.int32)


def anchors_from_gps(frames_meta, plane_se3=None):
    """Segment anchor poses from the dataset layer's GPS stream.

    frames_meta: iterable of objects with `gps_enu` [3] and an optional
    `pyr` attitude: the segments' FIRST frames. plane_se3: optional
    ground-plane SE3 [7]; anchors are in PLANE coordinates (what FastVO
    tracks in). Attitude from the drone PYR->rotation chain when present
    (MapFrame::getPrioryPose, GSLAM-DIYSLAM/src/MapFrame.cpp:370-402), else
    nadir. Returns [S, 7] float32, process_survey's `anchors`."""
    from ..utils import host_se3 as hse3

    out = []
    for fr in frames_meta:
        enu = np.asarray(fr.gps_enu, np.float64)
        pyr = getattr(fr, "pyr", None)
        if pyr is not None:
            from ..core.gps import pyr_to_rotation
            q = pyr_to_rotation(*[float(v) for v in pyr])
        else:
            q = np.array([1.0, 0.0, 0.0, 0.0])   # nadir (x, y, z, w)=(1,0,0,0)
        pose_w = np.concatenate([enu, q])
        if plane_se3 is not None:
            pose_w = hse3.se3_mul(hse3.se3_inv(
                np.asarray(plane_se3, np.float64)), pose_w)
        out.append(pose_w)
    return np.asarray(out, np.float32)


def anchors_from_coarse(vo, frames, firsts, pose0, scale: int = 4,
                        n_features: int | None = None):
    """GPS-free segment anchors from a coarse first pass.

    Pools the whole survey `scale`x (area average, per frame on the host),
    runs ONE serial track-only FastVO chain over it on vo's device and
    reads the segment first frames' poses as the anchors of the full-res
    segment-parallel run. The coarse chain drifts (it is serial VO), but
    every anchor sits on that one chain, so with correct_drift=True the
    full-res segments agree at their joints.

    vo: the full-res FastVO (plane geometry and camera are read from it).
    frames: [N, H, W(,3)], the WHOLE survey. firsts: [S] segment start
    indices (segments_from_frames). pose0: [7] plane-coordinate pose of
    frame 0 (the gauge anchor). Returns (anchors [S, 7] float32, coarse
    n_match [N])."""
    from ..models.fastvo import FastVO

    frames = np.asarray(frames)
    N, H, W = frames.shape[:3]
    H2, W2 = H // scale, W // scale
    ch = frames.shape[3:]
    fr = np.empty((N, H2, W2) + ch, np.float32)
    for i in range(N):
        f = frames[i, :H2 * scale, :W2 * scale].astype(np.float32)
        fr[i] = f.reshape((H2, scale, W2, scale) + ch).mean((1, 3))
    cam_s = vo.cam.scaled(1.0 / scale)
    nf = int(n_features or vo.params.n_features)
    vo_s = FastVO(cam_s, vo.min_xy, 1, vo.length_pixel, bands=1,
                  n_features=nf,
                  n_levels=min(getattr(vo.params, "n_levels", 4), 4),
                  window_radius=max(8.0, vo.window_radius / scale),
                  patch_tiles=1, detector=vo.detector, device=vo.device)
    with on(vo.device):
        poses, n_match = _segment_track(
            vo_s, torch.from_numpy(fr).to(vo.device),
            torch.as_tensor(pose0, dtype=torch.float32).to(vo.device))
        packed = torch.cat([poses, n_match[:, None]], -1).cpu().numpy()
    return packed[np.asarray(firsts), :7], packed[:, 7].astype(np.int32)


def segments_from_frames(frames, seg_len: int, overlap: int = 0):
    """Split a [N, H, W(,C)] survey into [S, K] segments (K = seg_len),
    tail-padded by repeating the last frame; consecutive segments can
    OVERLAP by `overlap` frames so the merged mosaic has no coverage gap
    at segment joints. Returns (segments [S, K, ...], first_indices [S]);
    feed first_indices into the dataset's GPS fixes to build anchors."""
    frames = np.asarray(frames)
    N = frames.shape[0]
    step = seg_len - overlap
    assert step > 0
    starts = list(range(0, max(N - overlap, 1), step))
    segs, firsts = [], []
    for s0 in starts:
        seg = frames[s0:s0 + seg_len]
        if seg.shape[0] < seg_len:
            seg = np.concatenate(
                [seg, np.repeat(seg[-1:], seg_len - seg.shape[0], 0)], 0)
        segs.append(seg)
        firsts.append(s0)
    return np.stack(segs), np.asarray(firsts)
