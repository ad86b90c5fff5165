"""Train the default SIFT vocabulary with the PyTorch port.

The port's counterpart of scripts/train_sift_vocab.py, the twin of
scripts/torch_train_default_vocab.py for the reference's default
detector: the same training views from seed 43, SIFT descriptors (128
float32) from the port's `sift_detect` (SiftParams(n_features=400,
n_octaves=4, contrast_threshold=0.02)) on `--device` (default cuda; it
raises without one), the k=10, L=3 vocabulary of raw float centres, saved
as a .gbow and embedded as a module. Like the ORB trainer it writes only
the paths it is given, never the port's `resources/`.

Usage: python scripts/torch_train_sift_vocab.py [out.gbow]
    [--module out.py] [--views 16] [--device cuda|cpu]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_train_default_vocab as orb_trainer  # noqa: E402
from pislamfusion_tpu_torch.ops.features import sift  # noqa: E402

SIFT_PARAMS = sift.SiftParams(n_features=400, n_octaves=4,
                              contrast_threshold=0.02)


def sift_descriptors(view):
    """The valid keypoints' descriptors [N, 128] float32 (numpy) of one
    view."""
    feats = sift.sift_detect(view, SIFT_PARAMS)
    return feats["desc"][feats["valid"]].float().cpu().numpy()


def train(n_views, device, log=print):
    """train_default_vocab's views from seed 43, SIFT descriptors, the
    k=10, L=3 vocabulary: (vocabulary, descriptors)."""
    return orb_trainer.train(n_views, device, describe=sift_descriptors,
                             seed=43, log=log)


def main(argv=None):
    args = orb_trainer.cli("sift", 16, argv)
    voc, _ = train(args.views, args.device)
    orb_trainer.save(voc, args.out_gbow, args.module, "sift_default.gbow")
    return 0


if __name__ == "__main__":
    sys.exit(main())
