"""Sharded orthomosaic compositing: the canvas pyramid striped over a mesh.

Port of pislamfusion_tpu/parallel/dist_mosaic.py:29-88. The reference
constrains the canvas to a row-striped layout (GSPMD's `P(axes)` on dim 0)
and lets XLA turn each composite into shard-local updates. Here each band
of the canvas is cut into row stripes over the flattened mesh (ceil-split
where the rows do not divide, `mesh.blocks`), each stripe lives on its
shard's device and stays there between frames (`Stripes`), and each
frame's patch pyramids (`ops/mosaic.patch_pyramids`: the warp, K8's
pyramids) are computed once, on the device of the first stripe the patch
overlaps, then composited into the rows of each stripe it overlaps, on
that stripe's device. The composite is per pixel, so the gathered canvas
equals the single-device one exactly.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..ops import mosaic as M
from .mesh import Mesh, blocks, on


class Stripes:
    """One canvas band cut into row stripes: `parts[s]` holds rows
    [starts[s], starts[s] + parts[s].shape[0]) on its shard's device."""

    def __init__(self, parts: List[torch.Tensor], starts: List[int]):
        self.parts = parts
        self.starts = starts

    def gather(self, device=None) -> torch.Tensor:
        """The whole band on `device` (default the first stripe's)."""
        d = self.parts[0].device if device is None else device
        return torch.cat([t.to(d) for t in self.parts])


def canvas_shardings(mesh: Mesh, bands: int):
    """The stripes' devices in row order for every band of the canvas
    pyramid (each band keeps the same row partitioning; all mesh axes
    combined stripe dim 0): (lap, w), bands + 1 lists each."""
    return [mesh.flat] * (bands + 1), [mesh.flat] * (bands + 1)


def _stripe(band: torch.Tensor, devices) -> Stripes:
    rows = blocks(band.shape[0], len(devices))
    return Stripes([band[a:b].to(d, copy=True)
                    for d, (a, b) in zip(devices, rows)],
                   [a for a, _ in rows])


def shard_canvas(canvas_lap: List[torch.Tensor],
                 canvas_w: List[torch.Tensor], mesh: Mesh):
    """Place an allocated canvas pyramid onto the mesh, row-striped."""
    lap_sh, w_sh = canvas_shardings(mesh, len(canvas_lap) - 1)
    return ([_stripe(c, d) for c, d in zip(canvas_lap, lap_sh)],
            [_stripe(c, d) for c, d in zip(canvas_w, w_sh)])


def gather_canvas(canvas_lap, canvas_w, device=None):
    """A striped canvas as whole bands on `device` (a canvas that is not
    striped comes back as it is)."""
    def whole(c):
        return c.gather(device) if isinstance(c, Stripes) else c
    return [whole(c) for c in canvas_lap], [whole(c) for c in canvas_w]


def _host_origins(origins_yx) -> np.ndarray:
    if isinstance(origins_yx, torch.Tensor):
        origins_yx = origins_yx.cpu().numpy()
    return np.asarray(origins_yx).astype(np.int64).reshape(-1, 2)


def _composite_striped(lap: List[Stripes], w: List[Stripes], p_lap, p_w,
                       oy: int, ox: int):
    """Composite a patch pyramid at band-0 origin (oy, ox) into the rows
    of the stripes it overlaps, each on its stripe's device."""
    for i in range(len(lap)):
        y0, x0 = oy >> i, ox >> i
        ph = p_lap[i].shape[0]
        for part_l, part_w, r0 in zip(lap[i].parts, w[i].parts,
                                      lap[i].starts):
            a = max(y0, r0)
            b = min(y0 + ph, r0 + part_l.shape[0])
            if a >= b:
                continue
            d = part_l.device
            with on(d):
                M.composite_patch([part_l], [part_w],
                                  [p_lap[i][a - y0:b - y0].to(d)],
                                  [p_w[i][a - y0:b - y0].to(d)],
                                  (a - r0, x0))


def _patch_device(lap0: Stripes, oy: int):
    """The device of the first stripe at or below band-0 row oy."""
    for part, r0 in zip(lap0.parts, lap0.starts):
        if oy < r0 + part.shape[0]:
            return part.device
    return lap0.parts[-1].device


def feed_frames(canvas_lap, canvas_w, imgs, h_mats, origins_yx, bands: int,
                patch_hw: Tuple[int, int], mesh: Mesh = None,
                weight_type: int = 0):
    """Composite a batch of frames into the canvas, in order. With a mesh,
    the canvas is row-striped across it (`Stripes` bands) and stays
    distributed between frames; without, it is composited in place on its
    device. imgs [K, H, W, 3]; h_mats [K, 3, 3] patch px -> image px;
    origins_yx [K, 2] band-0 canvas px, tile aligned. Returns (lap, w)."""
    origins = _host_origins(origins_yx)
    imgs = torch.as_tensor(imgs)
    h_mats = torch.as_tensor(h_mats, dtype=torch.float32)
    patch_hw = tuple(int(v) for v in patch_hw)
    if mesh is None:
        dev = canvas_lap[0].device
        for img, hm, (oy, ox) in zip(imgs, h_mats, origins):
            M.composite_frame(canvas_lap, canvas_w,
                              img.to(dev, torch.float32), hm.to(dev),
                              (int(oy), int(ox)), bands, patch_hw,
                              weight_type)
        return canvas_lap, canvas_w
    if not isinstance(canvas_lap[0], Stripes):
        canvas_lap, canvas_w = shard_canvas(canvas_lap, canvas_w, mesh)
    for img, hm, (oy, ox) in zip(imgs, h_mats, origins):
        d = _patch_device(canvas_lap[0], int(oy))
        with on(d):
            p_lap, p_w = M.patch_pyramids(img.to(d, torch.float32),
                                          hm.to(d), patch_hw, bands,
                                          weight_type)
        _composite_striped(canvas_lap, canvas_w, p_lap, p_w, int(oy),
                           int(ox))
    return canvas_lap, canvas_w
