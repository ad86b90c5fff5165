"""BoW vocabulary: hierarchical k-means tree as batched level-wise argmin.

Port of pislamfusion_tpu/ops/vocabulary.py (GSLAM/GSLAM/core/Vocabulary.h):
  * `.gbow` binary load/save, field-for-field compatible with
    Vocabulary::load/save (Vocabulary.h:1718-1843): uint64 magic
    88877711233, bool compressed, uint32 nnodes, int32 k/L/scoring/
    weighting, int32 cols/rows/type (OpenCV type code), then per node
    (ids 1..nnodes-1) uint64 parent + float32 weight + raw descriptor
    bytes, then uint32 word count + uint64 node id per word.
  * transform (Vocabulary.h:1501-1611): per-feature tree descent by argmin
    child distance, vectorized over ALL features at once: one gather +
    distance + argmin per tree level, on the descriptors' device.
  * distance (Vocabulary.h:2049-2102): popcount-Hamming for binary (uint8)
    descriptors, squared L2 for float descriptors.
  * TF_IDF weighting + L1 scoring (Vocabulary.h:567-612: the Nister-2006
    scaled L1 score) and meanValue (bit-majority / arithmetic mean).
  * training: hierarchical k-means with kmeans++ seeding
    (Vocabulary::create, :1013-1075) — host numpy (one-off offline step).

The tree lives on the host as numpy; `_device(device)` keeps one copy of
the descent tables per device. Everything but the descent (`_descend`) is
the reference's host code.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_GBOW_MAGIC = 88877711233

# Vocabulary.h enums
TF_IDF, TF, IDF, BINARY = 0, 1, 2, 3
L1_NORM, L2_NORM, CHI_SQUARE, KL, BHATTACHARYYA, DOT_PRODUCT = range(6)

# OpenCV type codes for the descriptor matrix header
_CV_8U, _CV_32F = 0, 5


class Vocabulary:
    """SoA vocabulary. Node 0 is the root (no descriptor/weight)."""

    def __init__(self, k: int = 10, L: int = 5, weighting: int = TF_IDF,
                 scoring: int = L1_NORM):
        self.k = int(k)
        self.L = int(L)
        self.weighting = int(weighting)
        self.scoring = int(scoring)
        self.node_desc: Optional[np.ndarray] = None    # [N, D] u8|f32
        self.node_parent: Optional[np.ndarray] = None  # [N] int64
        self.node_weight: Optional[np.ndarray] = None  # [N] f32
        self.node_children: Optional[np.ndarray] = None  # [N, k] int32, -1 pad
        self.node_word: Optional[np.ndarray] = None    # [N] int32, -1 if none
        self.words: Optional[np.ndarray] = None        # [W] node ids int32
        self._dev = {}                                 # device -> tables

    # ------------------------------------------------------------ properties
    def size(self) -> int:
        return 0 if self.words is None else int(len(self.words))

    def empty(self) -> bool:
        return self.size() == 0

    @property
    def is_binary(self) -> bool:
        return self.node_desc is not None and self.node_desc.dtype == np.uint8

    # -------------------------------------------------------------- builders
    def _finalize(self):
        """Build the padded child table + word ids from parents."""
        n = len(self.node_parent)
        children: Dict[int, list] = {}
        for i in range(1, n):
            children.setdefault(int(self.node_parent[i]), []).append(i)
        tab = np.full((n, self.k), -1, np.int32)
        for p, ch in children.items():
            tab[p, :len(ch)] = ch[:self.k]
        self.node_children = tab
        is_leaf = ~np.isin(np.arange(n), list(children.keys()))
        is_leaf[0] = n == 1
        if self.words is None:
            wnodes = np.nonzero(is_leaf)[0].astype(np.int32)
            self.words = wnodes
        self.node_word = np.full(n, -1, np.int32)
        self.node_word[self.words] = np.arange(len(self.words),
                                               dtype=np.int32)
        self._dev = {}

    def _device(self, device):
        """The descent tables on `device`, uploaded on first use there."""
        key = str(device)
        d = self._dev.get(key)
        if d is None:
            d = self._dev[key] = {k: torch.from_numpy(np.ascontiguousarray(
                a)).to(device) for k, a in (
                    ("desc", self.node_desc),
                    ("children", self.node_children.astype(np.int64)),
                    ("weight", self.node_weight),
                    ("word", self.node_word.astype(np.int64)))}
        return d

    # -------------------------------------------------------------- training
    @staticmethod
    def create(descriptors: np.ndarray, k: int = 10, L: int = 5,
               weighting: int = TF_IDF, scoring: int = L1_NORM,
               seed: int = 0) -> "Vocabulary":
        """Hierarchical k-means training (Vocabulary::create). descriptors:
        [M, D] uint8 (binary) or float32."""
        voc = Vocabulary(k, L, weighting, scoring)
        binary = descriptors.dtype == np.uint8
        rng = np.random.default_rng(seed)
        desc_f = (np.unpackbits(descriptors, axis=1).astype(np.float32)
                  if binary else descriptors.astype(np.float32))

        parents = [0]          # node 0 = root
        node_desc = [np.zeros(descriptors.shape[1], descriptors.dtype)]

        def cluster(idx, level, parent):
            if level >= L or len(idx) == 0:
                return
            kk = min(k, len(idx))
            X = desc_f[idx]
            # kmeans++ seeding
            centers = [X[rng.integers(len(X))]]
            for _ in range(kk - 1):
                d2 = np.min(np.stack(
                    [np.sum((X - c) ** 2, -1) for c in centers]), 0)
                s = d2.sum()
                if s <= 0:
                    centers.append(X[rng.integers(len(X))])
                    continue
                centers.append(X[rng.choice(len(X), p=d2 / s)])
            C = np.stack(centers)
            for _ in range(8):  # Lloyd iterations
                d = ((X[:, None, :] - C[None]) ** 2).sum(-1)
                a = d.argmin(1)
                newC = np.stack([X[a == j].mean(0) if (a == j).any()
                                 else C[j] for j in range(kk)])
                if np.allclose(newC, C):
                    break
                C = newC
            for j in range(kk):
                members = idx[a == j]
                if len(members) == 0:
                    continue
                if binary:
                    # bit-majority center (meanValue for binary descriptors)
                    bits = (C[j] > 0.5).astype(np.uint8)
                    cdesc = np.packbits(bits)
                else:
                    cdesc = C[j].astype(np.float32)
                nid = len(node_desc)
                node_desc.append(cdesc)
                parents.append(parent)
                cluster(members, level + 1, nid)

        cluster(np.arange(len(descriptors)), 0, 0)
        voc.node_desc = np.stack(node_desc)
        voc.node_parent = np.asarray(parents, np.int64)
        voc.node_weight = np.zeros(len(parents), np.float32)
        voc._finalize()
        voc._set_weights(descriptors)
        return voc

    def _set_weights(self, training: np.ndarray):
        """IDF weights from the training set (TF_IDF/IDF); 1 otherwise."""
        if self.weighting in (TF, BINARY):
            self.node_weight[:] = 0.0
            self.node_weight[self.words] = 1.0
            self._dev = {}
            return
        wid, _, _ = self.transform_arrays(training)
        wid = _host(wid)
        counts = np.bincount(wid[wid >= 0], minlength=self.size())
        n = max(len(training), 1)
        idf = np.log(n / np.maximum(counts, 1e-12))
        idf[counts == 0] = 0.0
        self.node_weight[:] = 0.0
        self.node_weight[self.words] = idf.astype(np.float32)
        self._dev = {}

    # ------------------------------------------------------------- transform
    def transform_arrays(self, desc, valid=None, levelsup: int = 0):
        """Batched tree descent. desc: [F, D] array or tensor (uint8
        bit-packed for binary); it runs on the tensor's device (a numpy
        array runs on the CPU). Returns (word_id [F] int32, weight [F]
        f32, node_id [F] int32) tensors with -1/-0 entries where valid is
        False."""
        desc = torch.as_tensor(desc)
        d = self._device(desc.device)
        if self.is_binary and desc.shape[-1] == self.node_desc.shape[1] * 8:
            # accept the extractor's {0,1} bit-planes: pack to the
            # vocabulary's byte layout (8 bits -> 1 byte, LSB first)
            b = desc.reshape(desc.shape[0], -1, 8).to(torch.int32)
            weights = 2 ** torch.arange(8, dtype=torch.int32,
                                        device=desc.device)
            desc = (b * weights).sum(-1).to(torch.uint8)
        if valid is None:
            valid = torch.ones(desc.shape[0], dtype=torch.bool,
                               device=desc.device)
        valid = torch.as_tensor(valid).to(desc.device)
        nid_level = self.L - levelsup
        wid, w, nid = _descend(desc, d["desc"], d["children"], d["weight"],
                               d["word"], self.L, nid_level,
                               self.is_binary)
        wid = torch.where(valid, wid, -1)
        w = torch.where(valid, w, 0.0)
        nid = torch.where(valid, nid, -1)
        return wid, w, nid

    def bow_vector(self, word_ids, weights) -> Dict[int, float]:
        """Host BowVector (word -> weight) with the reference's TF_IDF
        accumulate + L1 normalize (addWeight/normalize)."""
        wid = _host(word_ids)
        w = _host(weights)
        sel = wid >= 0
        if self.weighting in (TF_IDF, TF):
            acc = np.zeros(self.size(), np.float64)
            np.add.at(acc, wid[sel], w[sel])
        else:   # IDF/BINARY: set once
            acc = np.zeros(self.size(), np.float64)
            acc[wid[sel]] = w[sel]
        nz = np.nonzero(acc > 0)[0]
        if len(nz) == 0:
            return {}
        vals = acc[nz]
        if self.scoring in (L1_NORM, CHI_SQUARE, KL, BHATTACHARYYA):
            vals = vals / vals.sum()
        elif self.scoring == L2_NORM:
            vals = vals / np.sqrt((vals ** 2).sum())
        return {int(i): float(v) for i, v in zip(nz, vals)}

    def transform(self, desc, valid=None, levelsup: int = 0):
        """Full reference surface: (BowVector dict, FeatureVector dict
        node_id -> [feature indices])."""
        wid, w, nid = self.transform_arrays(desc, valid, levelsup)
        bow = self.bow_vector(wid, w)
        nidn = _host(nid)
        fv: Dict[int, list] = {}
        for i in np.nonzero(nidn >= 0)[0]:
            fv.setdefault(int(nidn[i]), []).append(int(i))
        return bow, fv

    @staticmethod
    def score_l1(a: Dict[int, float], b: Dict[int, float]) -> float:
        """Nister-2006 scaled L1 score in [0, 1] (L1Scoring::score)."""
        s = 0.0
        for k_, va in a.items():
            vb = b.get(k_)
            if vb is not None:
                s += abs(va - vb) - abs(va) - abs(vb)
        return -s / 2.0

    def score(self, a: Dict[int, float], b: Dict[int, float]) -> float:
        if self.scoring == L2_NORM:
            d = sum(va * b[k_] for k_, va in a.items() if k_ in b)
            return float(d)
        return self.score_l1(a, b)

    # ------------------------------------------------------- distance / mean
    @staticmethod
    def distance(a: np.ndarray, b: np.ndarray) -> float:
        """Vocabulary::distance (:2049-2102)."""
        if a.dtype == np.uint8:
            return float(np.unpackbits(np.bitwise_xor(a, b)).sum())
        d = a.astype(np.float32) - b.astype(np.float32)
        return float(np.dot(d, d))

    @staticmethod
    def mean_value(descs: np.ndarray) -> np.ndarray:
        """Vocabulary::meanValue: bit-majority for binary, mean for float."""
        if descs.dtype == np.uint8:
            bits = np.unpackbits(descs, axis=1)
            return np.packbits(bits.sum(0) * 2 >= len(descs), axis=-1)
        return descs.mean(0).astype(descs.dtype)

    # ----------------------------------------------------------------- IO
    def save(self, path: str) -> bool:
        """Write .gbow (layout: Vocabulary::save, :1718-1777)."""
        n = len(self.node_parent)
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", _GBOW_MAGIC))
            f.write(struct.pack("<?", False))            # compressed
            f.write(struct.pack("<I", n))
            f.write(struct.pack("<iiii", self.k, self.L, self.scoring,
                                self.weighting))
            cols = self.node_desc.shape[1]
            ctype = _CV_8U if self.is_binary else _CV_32F
            f.write(struct.pack("<iii", cols, 1, ctype))
            for i in range(1, n):
                f.write(struct.pack("<Q", int(self.node_parent[i])))
                f.write(struct.pack("<f", float(self.node_weight[i])))
                f.write(self.node_desc[i].tobytes())
            f.write(struct.pack("<I", len(self.words)))
            for nid in self.words:
                f.write(struct.pack("<Q", int(nid)))
        return True

    @staticmethod
    def load(path: str) -> Optional["Vocabulary"]:
        """Read .gbow (layout: Vocabulary::load, :1781-1841)."""
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            raw = f.read()
        return Vocabulary.loads(raw)

    @staticmethod
    def loads(raw: bytes) -> Optional["Vocabulary"]:
        """Parse .gbow bytes (e.g. the embedded default vocabulary)."""
        off = 0

        def rd(fmt):
            nonlocal off
            vals = struct.unpack_from("<" + fmt, raw, off)
            off += struct.calcsize("<" + fmt)
            return vals if len(vals) > 1 else vals[0]

        if rd("Q") != _GBOW_MAGIC:
            return None
        if rd("?"):   # compressed unsupported, like the reference
            return None
        n = rd("I")
        if n == 0:
            return None
        k, L, scoring, weighting = rd("iiii")
        cols, _rows, ctype = rd("iii")
        binary = (ctype & 7) == _CV_8U
        esz = cols * (1 if binary else 4)
        dt = np.uint8 if binary else np.float32
        voc = Vocabulary(k, L, weighting, scoring)
        parent = np.zeros(n, np.int64)
        weight = np.zeros(n, np.float32)
        desc = np.zeros((n, cols), dt)
        for i in range(1, n):
            parent[i] = rd("Q")
            weight[i] = rd("f")
            desc[i] = np.frombuffer(raw, dt, cols, off)
            off += esz
        nwords = rd("I")
        words = np.zeros(nwords, np.int32)
        for i in range(nwords):
            words[i] = rd("Q")
        voc.node_parent = parent
        voc.node_weight = weight
        voc.node_desc = desc
        voc.words = words
        voc._finalize()
        return voc


def _host(x) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# batched descent
# ---------------------------------------------------------------------------

_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int32)


def _descend(desc, node_desc, children, node_weight, node_word,
             L: int, nid_level: int, binary: bool):
    """L level steps of the descent for all F features at once: each
    gathers the current nodes' children [F, k], their descriptors
    [F, k, D], the distances and the first argmin. Returns (word_id,
    weight, node id at level `nid_level`) as int32 / f32 / int32."""
    F = desc.shape[0]
    dev = desc.device
    cur = torch.zeros(F, dtype=torch.int64, device=dev)
    nid = torch.zeros(F, dtype=torch.int64, device=dev) if nid_level <= 0 \
        else torch.full((F,), -1, dtype=torch.int64, device=dev)
    if binary:
        du = desc.to(torch.uint8)
        pop = _POPCOUNT.to(dev)

        def dist_to(ch):
            cd = node_desc[ch.clamp(min=0)]               # [F, k, D] u8
            x = torch.bitwise_xor(cd, du[:, None, :])
            return pop[x.long()].sum(-1).to(torch.float32)
    else:
        df = desc.to(torch.float32)

        def dist_to(ch):
            cd = node_desc[ch.clamp(min=0)]               # [F, k, D] f32
            d = cd - df[:, None, :]
            return torch.sum(d * d, -1)

    for lvl in range(L):
        ch = children[cur]                                # [F, k]
        chv = ch >= 0
        dist = torch.where(chv, dist_to(ch), torch.inf)
        best = _first_argmin(dist)
        new = torch.gather(ch, 1, best[:, None])[:, 0]
        has = chv.any(-1)
        cur = torch.where(has, new, cur)
        # record the node at nid_level (only for features still descending)
        if lvl + 1 == nid_level:
            nid = torch.where(has, cur, nid)
    wid = node_word[cur]
    w = node_weight[cur]
    w = torch.where(wid >= 0, w, 0.0)
    return wid.to(torch.int32), w, nid.to(torch.int32)


def _first_argmin(x):
    """Index of each row's first minimum (jnp.argmin's ties)."""
    m = x.min(-1, keepdim=True).values
    ar = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == m, ar, x.shape[-1]).min(-1).values
