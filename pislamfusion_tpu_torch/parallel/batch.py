"""Data-parallel frame processing over a device mesh.

Port of pislamfusion_tpu/parallel/batch.py:20-73. A batch of frames is cut
over the mesh's `dp` axis; each shard's frames go through the
single-image detector (`orb_detect`: K1 or K7, K4, K2; `sift_detect`: K5,
K6) on its shard's device, and the results are stacked in batch order on
the mesh's first device, equal to the detector's output for each image.
Without a mesh the frames run on their own device.
"""
from __future__ import annotations

import torch

from ..ops import matching
from ..ops.features import orb, sift
from .mesh import Mesh, axis_devices, blocks, gather, on, shard_batch


def _batched(detect, images, mesh: Mesh = None):
    images = torch.as_tensor(images)
    if mesh is None:
        parts = [images]
    else:
        parts = shard_batch(mesh, images, "dp")
    feats = []
    for part in parts:
        with on(part.device):
            feats += [detect(im) for im in part]
    keys = list(feats[0])
    return dict(zip(keys, gather([tuple(f[k] for k in keys)
                                  for f in feats])))


def batched_orb_detect(images, params: orb.OrbParams, mesh: Mesh = None,
                       pyramid: str = "flat"):
    """images: [B, H, W] -> dict of [B, ...] feature arrays, the batch
    sharded over 'dp' with a mesh."""
    return _batched(lambda im: orb.orb_detect(im, params, pyramid), images,
                    mesh)


def batched_sift_detect(images, params: sift.SiftParams, mesh: Mesh = None):
    """images: [B, H, W] -> dict of [B, ...] SIFT feature arrays, the batch
    sharded over 'dp' with a mesh (the reference system's default
    detector, scaled the same way as ORB)."""
    return _batched(lambda im: sift.sift_detect(im.to(torch.float32),
                                                params), images, mesh)


def batched_consecutive_match(feats, kind: str = "orb",
                              max_dist: float = 80.0, mesh: Mesh = None,
                              wrap: bool = True):
    """Match frame t against frame t+1 for a whole batch at once.

    wrap=True matches frame B-1 back to frame 0 so the output batch keeps
    size B (stays divisible by the dp axis); wrap=False returns B-1 rows.
    [B, N, D] descriptors -> (idx [B(,-1), N], ok [B(,-1), N]), on the
    first shard's device."""
    desc, valid = feats["desc"], feats["valid"]
    if wrap:
        da, va = desc, valid
        db, vb = torch.roll(desc, -1, 0), torch.roll(valid, -1, 0)
    else:
        da, va = desc[:-1], valid[:-1]
        db, vb = desc[1:], valid[1:]
    n = da.shape[0]
    if mesh is None:
        parts = [(desc.device, (0, n))]
    else:
        devs = axis_devices(mesh, "dp")
        parts = list(zip(devs, blocks(n, len(devs))))
    out = []
    for d, (a, b) in parts:
        with on(d):
            for i in range(a, b):
                out.append(matching.match_descriptors(
                    da[i].to(d), va[i].to(d), db[i].to(d), vb[i].to(d),
                    kind, max_dist=max_dist))
    return gather(out, desc.device)
