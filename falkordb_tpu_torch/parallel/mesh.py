"""The device mesh of one controlling process, and its collectives.

falkordb_tpu runs its mesh code under `shard_map` over a
`jax.sharding.Mesh`: one process drives every device, and XLA's
collectives (psum, pmin, all_gather, ...) combine the shards.  The port
keeps that shape.  A `Mesh` holds a numpy object array of torch devices, of
shape (P,) or (R, C), with its axis names; devices may repeat, so P shards
can share one card.  A sharded value is a list of per-shard tensors, each
on its shard's device, in row-major order for a 2D mesh.

Each collective combines a group of shards in shard order on the group's
first device with torch ops (add, minimum, maximum, cat), then copies the
result to each shard's device with `.to`: a run gives the same bits every
time.  Where shards share a device they share the combined tensor (`.to`
to the same device returns it), so no caller may write into a collective's
output in place.  These combines stand for XLA's collectives, not for a
kernel of falkordb_tpu.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """Devices laid out on named axes: `devices` is a numpy object array of
    torch.device of shape (P,) or (R, C); `axis_names` names its axes."""

    def __init__(self, devices, axis_names):
        src = np.array(devices, dtype=object)
        self.devices = np.empty(src.shape, dtype=object)
        for i, d in np.ndenumerate(src):
            self.devices[i] = torch.device(d)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} with axes "
                             f"{self.axis_names}")

    @property
    def flat(self) -> list:
        """The shards' devices in row-major order."""
        return list(self.devices.reshape(-1))


def groups(mesh: Mesh, axes) -> list[list[int]]:
    """The shards that one collective over `axes` (a name or a tuple of
    names) combines: lists of flat shard indices, each in axis order."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"no axis {a!r} in mesh axes {mesh.axis_names}")
    shape = mesh.devices.shape
    idx = np.arange(mesh.devices.size).reshape(shape)
    over = [mesh.axis_names.index(a) for a in axes]
    keep = [d for d in range(len(shape)) if d not in over]
    idx = idx.transpose(keep + over).reshape(
        int(np.prod([shape[d] for d in keep], dtype=np.int64)), -1)
    return [list(map(int, row)) for row in idx]


def _folds(mesh, xs, axes, fold):
    """(group, its values folded in shard order on its first device)."""
    devs = mesh.flat
    for g in groups(mesh, axes):
        home = devs[g[0]]
        acc = xs[g[0]].to(home)
        for k in g[1:]:
            acc = fold(acc, xs[k].to(home))
        yield g, acc


def _combine(mesh, xs, axes, fold):
    out = [None] * len(xs)
    devs = mesh.flat
    for g, acc in _folds(mesh, xs, axes, fold):
        for k in g:
            out[k] = acc.to(devs[k])
    return out


def psum(xs, mesh, axes):
    return _combine(mesh, xs, axes, torch.add)


def pmin(xs, mesh, axes):
    return _combine(mesh, xs, axes, torch.minimum)


def pmax(xs, mesh, axes):
    return _combine(mesh, xs, axes, torch.maximum)


def all_gather(xs, mesh, axes):
    """Tiled: each shard gets its group's values concatenated along dim 0,
    in group order."""
    out = [None] * len(xs)
    devs = mesh.flat
    for g in groups(mesh, axes):
        home = devs[g[0]]
        acc = torch.cat([xs[k].to(home) for k in g])
        for k in g:
            out[k] = acc.to(devs[k])
    return out


def psum_scatter(xs, mesh, axes):
    """Tiled: the group's sum, cut into as many equal blocks along dim 0 as
    the group has shards; shard i of the group gets block i."""
    out = [None] * len(xs)
    devs = mesh.flat
    for g, acc in _folds(mesh, xs, axes, torch.add):
        if acc.shape[0] % len(g):
            raise ValueError(f"{acc.shape[0]} rows do not split over "
                             f"{len(g)} shards")
        for i, blk in enumerate(acc.chunk(len(g))):
            out[g[i]] = blk.to(devs[g[i]])
    return out


def all_to_all(xs, mesh, axes):
    """split_axis = concat_axis = 0: shard i of a group cuts its value into
    len(group) blocks along dim 0 and sends block j to shard j; shard j
    gets the blocks from shards 0, 1, ... concatenated in that order."""
    out = [None] * len(xs)
    devs = mesh.flat
    for g in groups(mesh, axes):
        cut = [xs[k].chunk(len(g)) for k in g]
        for j, k in enumerate(g):
            out[k] = torch.cat([c[j].to(devs[k]) for c in cut])
    return out


def replicate(mesh, value) -> list:
    """A host array as a replicated value: one copy per distinct device,
    shared by the shards on it."""
    t = torch.from_numpy(np.ascontiguousarray(value))
    made = {}
    return [made.setdefault(d, t.to(d)) for d in mesh.flat]


def scatter_rows(mesh, arr) -> list:
    """Row k of a (P, ...) or (R, C, ...) host array to shard k's device."""
    arr = np.asarray(arr)
    lead = mesh.devices.ndim
    flat = arr.reshape((-1,) + arr.shape[lead:])
    return [torch.from_numpy(np.ascontiguousarray(flat[k])).to(d)
            for k, d in enumerate(mesh.flat)]


def per_device(mesh, fn, *args) -> list:
    """fn over a replicated value, once per distinct device: shard k's
    result is fn(*args at shard k), computed for the first shard on its
    device and shared by the others there.  Lists in `args` are sharded
    values; anything else goes to every call as it is."""
    done = {}
    out = []
    for k, d in enumerate(mesh.flat):
        if d not in done:
            done[d] = fn(*(a[k] if isinstance(a, list) else a
                           for a in args))
        out.append(done[d])
    return out


def per_shard(mesh, fn, *args) -> list:
    """fn at every shard (its own data)."""
    return [fn(*(a[k] if isinstance(a, list) else a for a in args))
            for k in range(mesh.devices.size)]


def unzip(results) -> tuple[list, ...]:
    """[(a0, b0), (a1, b1), ...] -> ([a0, a1, ...], [b0, b1, ...])."""
    return tuple(list(x) for x in zip(*results))
