"""Mesh routing for the algo procedures and the query path.

falkordb_tpu routes `CALL algo.pageRank / bfs / SSSP / WCC` (and large
MATCH expansions, parallel/qdist.py) through its edge-partitioned mesh
drivers when more than one JAX device is visible.  Here the candidate
devices are the visible devices of the store's device type: every CUDA card
for a store on CUDA, the one CPU device for a store on the CPU.  So the
mesh engages only with two or more cards, as the reference's does only with
two or more devices.

FALKOR_DIST=0 turns routing off.  FALKOR_MESH_DEVICES lists the mesh's
devices instead: comma-separated torch device names, where `name*k`
repeats one k times (`cpu*8`, `cuda:0*4`): the port's stand-in for the
reference's virtual host devices (--xla_force_host_platform_device_count).
A listed device of another type than the store's raises ValueError, and so
does a CUDA device that is not there: nothing moves to the CPU on its own.
"""

from __future__ import annotations

import os

import torch

from falkordb_tpu_torch.parallel.dist import make_mesh

_cached_mesh = None


def mesh_devices(device) -> list:
    """The candidate mesh devices for a store on `device`."""
    device = torch.device(device)
    spec = os.environ.get("FALKOR_MESH_DEVICES", "").strip()
    if not spec:
        if device.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [device]
    out = []
    for item in spec.split(","):
        name, _, rep = item.strip().partition("*")
        d = torch.device(name.strip())
        if d.type != device.type:
            raise ValueError(f"FALKOR_MESH_DEVICES lists {d}, but the store "
                             f"lives on {device}")
        if d.type == "cuda":
            d = torch.device("cuda", d.index or 0)
            if d.index >= torch.cuda.device_count():
                raise ValueError(f"FALKOR_MESH_DEVICES lists {d}, which is "
                                 f"not there ({torch.cuda.device_count()} "
                                 f"CUDA devices)")
        out += [d] * (int(rep) if rep else 1)
    return out


def maybe_mesh(device, min_devices: int = 2):
    """The process-wide algo mesh for a store on `device`, or None when
    distribution is off or fewer than min_devices are candidates (the
    common one-card case)."""
    global _cached_mesh
    if os.environ.get("FALKOR_DIST", "1") == "0":
        return None
    devices = mesh_devices(device)
    if len(devices) < min_devices:
        return None
    if _cached_mesh is None or _cached_mesh.flat != devices:
        _cached_mesh = make_mesh(devices)
    return _cached_mesh
