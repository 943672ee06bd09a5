"""Multi-device distribution: one graph's edges sharded over a device mesh.

The port of falkordb_tpu/parallel: one controlling process holds a list of
per-shard tensors, one for each mesh device (parallel/mesh.py); each
shard's kernels (K23-K26) launch on its own device and the collectives are
combines in shard order.  The same code runs with P shards on P cards, or
with P shards on one card (FALKOR_MESH_DEVICES=cuda:0*4, parallel/router.py).
"""

from falkordb_tpu_torch.parallel.dist import (  # noqa: F401
    make_mesh,
    make_mesh_2d,
    dist_pagerank_step,
    dist_bfs_level,
    dist_pagerank,
    dist_bfs,
    dist_bfs_2d,
    dist_bfs_fused,
    dist_bfs_fused_bitmap,
    dist_sssp,
    dist_wcc,
    shard_edges_1d,
    shard_edges_2d,
)
