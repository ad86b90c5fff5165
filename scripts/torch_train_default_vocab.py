"""Train the default ORB vocabulary with the PyTorch port.

The port's counterpart of scripts/train_default_vocab.py: the same
training views from the same seed (augmented views of the real aerial
photograph and a synthetic minority, blurred with the port's
`ops/image.gaussian_blur`), ORB descriptors from the port's `orb_detect`
(OrbParams(n_features=500, n_levels=4), `pack_bits`) on `--device`
(default cuda; it raises without one), a hierarchical k-means vocabulary
(`Vocabulary.create(k=10, L=3)`: up to 1000 words), saved as a .gbow and
embedded as an importable module (`resource.generate_module`).

It writes only the two paths it is given (by default under the temporary
directory), and refuses the port's `resources/` folder: the vocabularies
the port ships stay copies of the JAX package's, so that BoW parity
between the packages holds.

Usage: python scripts/torch_train_default_vocab.py [out.gbow]
    [--module out.py] [--views 24] [--device cuda|cpu]
"""
import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pislamfusion_tpu_torch.core import resource  # noqa: E402
from pislamfusion_tpu_torch.core.device import resolve_device  # noqa: E402
from pislamfusion_tpu_torch.ops import image as im  # noqa: E402
from pislamfusion_tpu_torch.ops.features import orb  # noqa: E402
from pislamfusion_tpu_torch.ops.vocabulary import Vocabulary  # noqa: E402

AERIAL_PNG = os.path.join(ROOT, "tests", "data", "aerial_npu.png")
RESOURCES = os.path.join(ROOT, "pislamfusion_tpu_torch", "resources")
ORB_PARAMS = orb.OrbParams(n_features=500, n_levels=4)


def _blur(v, sigma, device):
    """The port's gaussian_blur of a [H, W] numpy view, clipped to 0..255
    first: a [H, W] float32 tensor on `device`."""
    x = torch.from_numpy(np.clip(v, 0, 255).astype(np.float32)).to(device)
    return im.gaussian_blur(x[..., None], sigma)[..., 0]


def real_views(rng, n, device, size=(480, 640)):
    """train_default_vocab.real_views: augmented views of the real aerial
    photograph (tests/data/aerial_npu.png): a random crop window,
    rotation, scale, brightness and contrast jitter, blur."""
    from PIL import Image
    a = np.asarray(Image.open(AERIAL_PNG).convert("L"), np.float32)
    a = np.concatenate([a, a[:, ::-1]], 1)
    a = np.concatenate([a, a[::-1]], 0)            # seamless mirror tile
    big = np.asarray(Image.fromarray(a.astype(np.uint8)).resize(
        (1280, 1280), Image.LANCZOS), np.float32)
    h, w = size
    for _ in range(n):
        ang = float(rng.uniform(0, 360))
        view = Image.fromarray(big.astype(np.uint8)).rotate(
            ang, Image.BILINEAR)
        s = float(rng.uniform(0.7, 1.3))
        vw, vh = int(w / s), int(h / s)
        x0 = rng.integers(160, 1280 - vw - 160)
        y0 = rng.integers(160, 1280 - vh - 160)
        crop = view.crop((x0, y0, x0 + vw, y0 + vh)).resize(
            (w, h), Image.BILINEAR)
        v = np.asarray(crop, np.float32)
        v = (v - 127.5) * float(rng.uniform(0.8, 1.2)) + 127.5 \
            + float(rng.uniform(-20, 20))
        yield _blur(v, float(rng.uniform(0.4, 1.2)), device)


def synth_textures(rng, n, device):
    """train_default_vocab._synth_textures: blobs, stripes, gradients,
    speckle."""
    for i in range(n):
        base = np.full((480, 640), 120.0, np.float32)
        base += rng.normal(0, 10, base.shape)
        for _ in range(rng.integers(150, 400)):
            y, x = rng.integers(0, 440), rng.integers(0, 600)
            h, w = rng.integers(4, 40, 2)
            base[y:y + h, x:x + w] = rng.uniform(20, 235)
        if i % 3 == 0:   # field stripes
            period = rng.integers(8, 40)
            phase = np.arange(640) % period < period // 2
            base += np.where(phase[None, :], 15.0, -15.0)
        if i % 4 == 0:   # illumination gradient
            base += np.linspace(-25, 25, 640)[None, :]
        yield _blur(base, float(rng.uniform(0.6, 1.8)), device)


def textures(rng, n, device):
    """train_default_vocab.textures: two thirds real views, then the
    synthetic rest, [480, 640] float32 tensors on `device`."""
    n_real = (2 * n) // 3
    yield from real_views(rng, n_real, device)
    yield from synth_textures(rng, n - n_real, device)


def orb_descriptors(view):
    """The valid keypoints' packed descriptors [N, 32] uint8 (numpy) of one
    view."""
    feats = orb.orb_detect(view, ORB_PARAMS)
    valid = feats["valid"]
    return orb.pack_bits(feats["desc"][valid]).cpu().numpy()


def train(n_views, device, describe=orb_descriptors, seed=42, log=print):
    """Extract from `n_views` training views drawn from `seed` on `device`
    and train the k=10, L=3 vocabulary. Returns (vocabulary, the
    descriptors it was trained on)."""
    device = resolve_device(device)
    descs = []
    for i, view in enumerate(textures(np.random.default_rng(seed),
                                      n_views, device)):
        descs.append(describe(view))
        log(f"texture {i}: {len(descs[-1])} descriptors")
    D = np.concatenate(descs, 0)
    log(f"training on {len(D)} descriptors...")
    voc = Vocabulary.create(D, k=10, L=3)
    log(f"vocabulary: {voc.size()} words, {len(voc.node_parent)} nodes")
    return voc, D


def check_out_path(path):
    """Refuse a path inside the port's shipped resources."""
    if os.path.commonpath([os.path.abspath(path), RESOURCES]) == RESOURCES:
        raise SystemExit(f"{path}: the port's shipped vocabularies are "
                         "copies of the JAX package's; write elsewhere")
    return path


def save(voc, out_gbow, out_py, resource_name):
    """Save the .gbow and embed it as a module registering
    `resource_name`."""
    voc.save(out_gbow)
    resource.generate_module(out_gbow, resource_name, out_py)
    print(f"embedded -> {out_py} ({os.path.getsize(out_py)} bytes)")


def cli(name, views, argv):
    """The trainers' command line: (args) with out_gbow, module, views and
    device, the paths by default under the temporary directory and never
    inside the port's resources."""
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser()
    ap.add_argument("out_gbow", nargs="?",
                    default=os.path.join(tmp, f"{name}_default.gbow"))
    ap.add_argument("--module",
                    default=os.path.join(tmp, f"{name}_vocab.py"))
    ap.add_argument("--views", type=int, default=views)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    check_out_path(args.out_gbow)
    check_out_path(args.module)
    return args


def main(argv=None):
    args = cli("orb", 24, argv)
    voc, _ = train(args.views, args.device)
    save(voc, args.out_gbow, args.module, "orb_default.gbow")
    return 0


if __name__ == "__main__":
    sys.exit(main())
