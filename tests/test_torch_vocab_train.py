"""The vocabulary trainers on the PyTorch port, on the CPU
(`scripts/torch_train_default_vocab.py`, `scripts/torch_train_sift_vocab.py`)
against the JAX package's (`scripts/train_default_vocab.py`,
`scripts/train_sift_vocab.py`).

The training views from the same seed within 1e-3 gray (the blur is each
package's own), and `Vocabulary.create` of both packages on the same
descriptors (packed ORB bits of one view, SIFT floats of one view): the
saved .gbow byte for byte. The trainers themselves run on the card
(chip_smoke.py phase 2i).
"""
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(REPO, "scripts") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_train_default_vocab as torb  # noqa: E402
import torch_train_sift_vocab as tsift  # noqa: E402
import train_default_vocab as jorb  # noqa: E402
from torch_port_reference import torch_one_thread  # noqa: E402,F401

VIEW_TOL = 1e-3


def _first_two(views):
    return [np.asarray(v.cpu() if hasattr(v, "cpu") else v)
            for v, _ in zip(views, range(2))]


@pytest.mark.parametrize("kind", ["real", "synthetic"])
def test_training_views_match_reference(kind, torch_one_thread):
    """The first two real and the first two synthetic views of seed 42, as
    [480, 640] float32, within 1e-3 gray of the JAX trainer's."""
    if kind == "real":
        j = _first_two(jorb.real_views(np.random.default_rng(42), 2))
        t = _first_two(torb.real_views(np.random.default_rng(42), 2, "cpu"))
    else:
        j = _first_two(jorb._synth_textures(np.random.default_rng(42), 2))
        t = _first_two(torb.synth_textures(np.random.default_rng(42), 2,
                                           "cpu"))
    for a, b in zip(t, j):
        assert a.shape == b.shape == (480, 640) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=VIEW_TOL)


def test_textures_order_real_then_synthetic(torch_one_thread):
    """textures(n): two thirds real views, then the synthetic rest, drawn
    from one rng in the JAX trainer's order."""
    t = list(torb.textures(np.random.default_rng(5), 3, "cpu"))
    rng = np.random.default_rng(5)
    real = list(torb.real_views(rng, 2, "cpu"))
    synth = list(torb.synth_textures(rng, 1, "cpu"))
    for a, b in zip(t, real + synth):
        assert bool((a == b).all())


@pytest.mark.parametrize("detector", ["orb", "sift"])
def test_vocabulary_create_matches_reference(detector, tmp_path,
                                             torch_one_thread):
    """Both packages' Vocabulary.create(k=10, L=3) on the port's descriptors
    of one training view: the .gbow files equal byte for byte."""
    from pislamfusion_tpu.ops.vocabulary import Vocabulary as JVocabulary
    from pislamfusion_tpu_torch.ops.vocabulary import Vocabulary
    seed, describe = ((42, torb.orb_descriptors) if detector == "orb"
                      else (43, tsift.sift_descriptors))
    view = next(torb.textures(np.random.default_rng(seed), 3, "cpu"))
    D = describe(view)
    assert D.dtype == (np.uint8 if detector == "orb" else np.float32)
    assert D.shape[1] == (32 if detector == "orb" else 128)
    assert len(D) > 300
    Vocabulary.create(D, k=10, L=3).save(str(tmp_path / "t.gbow"))
    JVocabulary.create(D, k=10, L=3).save(str(tmp_path / "j.gbow"))
    t = (tmp_path / "t.gbow").read_bytes()
    assert t == (tmp_path / "j.gbow").read_bytes()
    back = Vocabulary.load(str(tmp_path / "t.gbow"))
    assert 100 < back.size() <= 1000


def test_trainers_refuse_the_shipped_resources(tmp_path):
    """The trainers write only where they are told, never over the port's
    shipped vocabularies; the default device is cuda."""
    shipped = os.path.join(REPO, "pislamfusion_tpu_torch", "resources",
                           "orb_vocab.py")
    with pytest.raises(SystemExit, match="shipped"):
        torb.cli("orb", 24, [str(tmp_path / "o.gbow"), "--module", shipped])
    with pytest.raises(SystemExit, match="shipped"):
        torb.cli("sift", 16, [os.path.join(os.path.dirname(shipped),
                                           "sift.gbow")])
    args = torb.cli("sift", 16, [])
    assert args.device == "cuda" and args.views == 16
    assert os.path.dirname(args.out_gbow) == os.path.dirname(args.module)
