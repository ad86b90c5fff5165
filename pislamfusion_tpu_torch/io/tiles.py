"""Tile pyramid management (web-mercator z/x/y tiles).

Equivalent of GSLAM/GSLAM/core/TileManager.h (TileBase/ImageTile ABC +
hashVal keying :10-54) and the projection half of TileProjection.h (the
WGS84 web-mercator mapping; the GCJ02/BD09 China-offset datum shifts of
the reference's GCJ02Projection/BaiduProjection live in core/gps.py —
datum_shift — and are applied at tile placement via GeoTiles.Datum).
`export_geo_tiles` (io/exporters.py) produces the leaf level; TileManager
holds/serves tiles in memory with an LRU bound and builds parent levels by
downsampling, mirroring the reference's use for map display and export.

A copy of pislamfusion_tpu/io/tiles.py: PNGs go through the port's own
`models.map2d._write_png` and `read_png`.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from .exporters import global_px_to_lnglat, lnglat_to_global_px


def tile_hash(x: int, y: int, z: int) -> int:
    """TileBase::hashVal (TileManager.h:35-40)."""
    return (z << 48) | (y << 24) | x


class ImageTile:
    """ImageTile (TileManager.h:48-54): image payload + z/x/y position."""

    def __init__(self, image: Optional[np.ndarray] = None,
                 position: Tuple[int, int, int] = (0, 0, -1),
                 timestamp: float = -1.0):
        self.image = image
        self.position = position      # (x, y, z); invalid when z < 0
        self.timestamp = timestamp
        self.modified = False

    def mem_size(self) -> int:
        return 0 if self.image is None else self.image.nbytes


class TileManager:
    """In-memory tile store keyed by hashVal, LRU-bounded, with parent-level
    synthesis by 2x2 downsampling and folder save/load (z/x/y.png)."""

    def __init__(self, max_bytes: int = 256 << 20):
        self._tiles: "OrderedDict[int, ImageTile]" = OrderedDict()
        self._bytes = 0
        self.max_bytes = max_bytes

    def set_tile(self, x: int, y: int, z: int, image: np.ndarray):
        key = tile_hash(x, y, z)
        old = self._tiles.pop(key, None)
        if old is not None:
            self._bytes -= old.mem_size()
        t = ImageTile(np.asarray(image), (x, y, z))
        t.modified = True
        self._tiles[key] = t
        self._bytes += t.mem_size()
        while self._bytes > self.max_bytes and len(self._tiles) > 1:
            _, ev = self._tiles.popitem(last=False)
            self._bytes -= ev.mem_size()

    def get_tile(self, x: int, y: int, z: int) -> Optional[ImageTile]:
        t = self._tiles.get(tile_hash(x, y, z))
        if t is not None:
            self._tiles.move_to_end(tile_hash(x, y, z))
        return t

    def __len__(self):
        return len(self._tiles)

    def positions(self, z: Optional[int] = None):
        return [t.position for t in self._tiles.values()
                if z is None or t.position[2] == z]

    def build_parent_level(self, z: int) -> int:
        """Synthesize level z-1 tiles from the 2x2 children at level z."""
        parents = {}
        for (x, y, tz) in self.positions(z):
            parents.setdefault((x // 2, y // 2), []).append((x, y))
        made = 0
        for (px, py), children in parents.items():
            canvas = np.full((512, 512, 3), 255, np.uint8)
            for (x, y) in children:
                t = self.get_tile(x, y, z)
                if t is None or t.image is None:
                    continue
                oy = (y - py * 2) * 256
                ox = (x - px * 2) * 256
                canvas[oy:oy + 256, ox:ox + 256] = t.image
            down = canvas.reshape(256, 2, 256, 2, 3).mean((1, 3))
            self.set_tile(px, py, z - 1, down.astype(np.uint8))
            made += 1
        return made

    def save(self, folder: str) -> int:
        from ..models.map2d import _write_png
        n = 0
        for t in self._tiles.values():
            x, y, z = t.position
            if z < 0 or t.image is None:
                continue
            d = os.path.join(folder, str(z), str(x))
            os.makedirs(d, exist_ok=True)
            _write_png(os.path.join(d, f"{y}.png"), t.image)
            n += 1
        return n

    @staticmethod
    def load(folder: str) -> "TileManager":
        from ..models.map2d import read_png
        tm = TileManager()
        for zdir in sorted(os.listdir(folder)):
            zpath = os.path.join(folder, zdir)
            if not (zdir.isdigit() and os.path.isdir(zpath)):
                continue
            for xdir in os.listdir(zpath):
                xpath = os.path.join(zpath, xdir)
                if not xdir.isdigit():
                    continue
                for f in os.listdir(xpath):
                    if f.endswith(".png"):
                        tm.set_tile(int(xdir), int(f[:-4]), int(zdir),
                                    read_png(os.path.join(xpath, f)))
        return tm


def lnglat_to_tile(lng: float, lat: float, zoom: int) -> Tuple[int, int]:
    x, y = lnglat_to_global_px(lng, lat, zoom)
    return int(x // 256), int(y // 256)


def tile_bounds(x: int, y: int, zoom: int):
    """((lng0, lat0), (lng1, lat1)) of a tile (north-west, south-east)."""
    nw = global_px_to_lnglat(x * 256, y * 256, zoom)
    se = global_px_to_lnglat((x + 1) * 256, (y + 1) * 256, zoom)
    return nw, se
