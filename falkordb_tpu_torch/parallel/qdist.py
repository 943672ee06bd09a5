"""Query-path mesh routing, single-device form.

falkordb_tpu routes MATCH expansion through a sharded edge table when more
than one device is visible (falkordb_tpu/parallel/qdist.py).  On one device
its `maybe_query_mesh` returns None and the operators take the local CSR
path; that outcome is all this module keeps.  The mesh route
(`frontier_gate`, `expand_rows`) waits for ROADMAP.md module 9, and the
operators reach it only when a mesh is returned."""

from __future__ import annotations


def maybe_query_mesh(g):
    """The mesh for MATCH-path expansion: always None here (one device)."""
    return None
