"""Embedded resources (FileResource analogues, core/resource.py).

Importing a submodule registers its blob; `orb_vocab` carries the default
ORB .gbow vocabulary (trained by scripts/train_default_vocab.py) so BoW
loop detection and appearance relocalization work out of the box, like
the reference's vocabulary embedded via FileResource.h.
"""
