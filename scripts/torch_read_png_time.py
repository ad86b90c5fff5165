"""Host time of the port's PNG decoder (`models.map2d._decode_png`, the
path `read_png` takes where PIL does not import) on a Map2D canvas.

    python scripts/torch_read_png_time.py [WIDTH HEIGHT]

Writes a smooth random RGB image of WIDTH x HEIGHT (default 3328 x 2304,
the Map2D Type 3 canvas of chip_smoke.py's strip) twice into a temporary
directory: with the port's own encoder (`_write_png`, filter None on
every row) and, where PIL imports, with PIL (a filter chosen for each
row, mostly Paeth); then prints the best of three decodes of each by the
port's decoder, and by PIL for comparison, in seconds, and whether the
two decoders agree. A CPU measurement of the machine it runs on.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pislamfusion_tpu_torch.models import map2d  # noqa: E402


def best_of(fn, n: int = 3) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main(argv):
    w, h = (int(argv[0]), int(argv[1])) if len(argv) == 2 else (3328, 2304)
    rng = np.random.default_rng(0)
    img = np.clip(np.cumsum(rng.integers(-3, 4, (h, w, 3)), 1) + 128, 0,
                  255).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    with tempfile.TemporaryDirectory() as d:
        files = {"port encoder": os.path.join(d, "port.png")}
        map2d._write_png(files["port encoder"], img)
        if Image is not None:
            files["PIL encoder"] = os.path.join(d, "pil.png")
            Image.fromarray(img).save(files["PIL encoder"])
        for label, path in files.items():
            with open(path, "rb") as f:
                data = f.read()
            out = map2d._decode_png(data, path)
            port_s = best_of(lambda: map2d._decode_png(data, path))
            line = (f"{w}x{h} RGB, {label} ({len(data) / 2**20:.1f} MiB): "
                    f"port decoder {port_s:.3f} s")
            if Image is not None:
                def pil():
                    with Image.open(path) as im:
                        return np.asarray(im.convert("RGB"))
                line += (f", PIL {best_of(pil):.3f} s, equal "
                         f"{bool(np.array_equal(out, pil()))}")
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
