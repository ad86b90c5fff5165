"""A mesh of devices in one process, and its two collectives.

Port of pislamfusion_tpu/parallel/mesh.py:19-48. The reference is a
single controller: one Python process drives every device through
`jax.sharding.Mesh`, `shard_map` and GSPMD, and XLA's collectives do the
reductions. Here a `Mesh` is a [dp, tp] array of `torch.device`s; each
shard's work is enqueued on its own device (inside `on(device)`, so a
kernel launched for a tensor on `cuda:1` goes to `cuda:1`'s stream), and
each collective is an explicit sum or gather over the shards in a fixed
order (shard 0 first), so a card run repeats bit for bit. A device may
appear more than once: `[cpu] * 8` is the reference's 8-device test mesh
(`--xla_force_host_platform_device_count=8`), `[cuda:0] * 4` four shards
on one card; shards on one device run one after another on its current
stream.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """devices: a [dp, tp] numpy object array of `torch.device`s;
    `axis_names` names its two axes; `shape[name]` is an axis' size."""

    def __init__(self, devices: np.ndarray, axis_names=("dp", "tp")):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> list:
        """Every shard's device in the flattened mesh order (`P(axes)`)."""
        return list(self.devices.reshape(-1))

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.flat]})")


def on(device):
    """The context a shard's work runs in: `torch.cuda.device(device)` on
    a CUDA device (its current device and stream), nothing on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def default_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Split devices into (dp, tp): tp gets factors up to 4, dp the rest."""
    tp = 1
    for cand in (4, 2):
        if n_devices % cand == 0:
            tp = cand
            break
    return n_devices // tp, tp


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Sequence = None, shape: Tuple[int, int] = None,
              axis_names=("dp", "tp")) -> Mesh:
    """A mesh over `devices` (default: every CUDA device; raises when
    there is none). A device may repeat."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass the devices "
                               "(e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = default_mesh_shape(n)
    assert shape[0] * shape[1] == n, (shape, n)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


def blocks(n: int, parts: int):
    """Contiguous [start, stop) ranges cutting n rows into `parts` blocks
    the way GSPMD cuts a dimension: ceil(n / parts) rows a block, the last
    blocks short or empty where n does not divide."""
    b = -(-n // parts)
    return [(min(i * b, n), min((i + 1) * b, n)) for i in range(parts)]


def axis_devices(mesh: Mesh, axis=None) -> list:
    """The shards of `axis` in order, each by its device: every device of
    the flattened mesh for None, else the first device of each index of
    that axis (the others along the remaining axis hold replicas)."""
    if axis is None:
        return mesh.flat
    k = mesh.axis_names.index(axis)
    return list(np.moveaxis(mesh.devices, k, 0).reshape(
        mesh.shape[axis], -1)[:, 0])


def shard_batch(mesh: Mesh, x, axis: str = "dp") -> list:
    """x's leading axis cut into contiguous blocks, one a shard of `axis`
    (None: of the flattened mesh), each on its shard's device."""
    devs = axis_devices(mesh, axis)
    return [x[a:b].to(d) for d, (a, b) in zip(devs, blocks(x.shape[0],
                                                          len(devs)))]


def replicate(mesh: Mesh, x) -> list:
    """x on every shard's device (the flattened mesh order)."""
    return [_tree(lambda t, d=d: t.to(d), x) for d in mesh.flat]


def _tree(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_tree(fn, v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(fn, v) for v in x)
    return x


def _zip_tree(fn, values):
    """fn over the matching leaves of the per-shard trees `values`."""
    v0 = values[0]
    if isinstance(v0, torch.Tensor):
        return fn([v for v in values])
    parts = [_zip_tree(fn, [v[i] for v in values]) for i in range(len(v0))]
    if hasattr(v0, "_fields"):
        return type(v0)(*parts)
    return type(v0)(parts)


def reduce_sum(values):
    """The sum of the per-shard values (tensors or tuples of them) on the
    first shard's device, added in shard order."""
    def add(leaves):
        acc = leaves[0]
        for v in leaves[1:]:
            acc = acc + v.to(acc.device)
        return acc
    return _zip_tree(add, values)


def psum(values, devices=None) -> list:
    """The sum of the per-shard values, in shard order on the first
    shard's device, handed to every shard: one copy a shard on its device
    (`devices`, default each value's own)."""
    total = reduce_sum(values)
    if devices is None:
        devices = [_first_leaf(v).device for v in values]
    return [_tree(lambda t, d=d: t.to(d), total) for d in devices]


def gather(values, device=None):
    """The per-shard values stacked in shard order on `device` (default
    the first shard's)."""
    def stack(leaves):
        d = leaves[0].device if device is None else device
        return torch.stack([v.to(d) for v in leaves])
    return _zip_tree(stack, values)


def all_gather(values, devices=None) -> list:
    """The per-shard values stacked in shard order, handed to every shard
    (one copy a shard on its device)."""
    if devices is None:
        devices = [_first_leaf(v).device for v in values]
    return [gather(values, d) for d in devices]


def _first_leaf(x):
    while not isinstance(x, torch.Tensor):
        x = x[0]
    return x
