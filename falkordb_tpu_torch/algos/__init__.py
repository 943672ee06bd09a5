"""Graph algorithms: the compact adjacency snapshots (common.py), the
algo.* procedures (procedures.py) and what they run.  On the card: BFS
levels (bfs.py, kernel K4), BFS with parents (K8), the multi-source BFS
(K16) behind harmonic centrality (harmonic.py) and the blocked-ELL BFS
family (K9, K10, K17, K12), PageRank (K5) and its ELL form (K18), WCC and
SSSP (K6), betweenness (K7), and the gated batched bit-packed BFS behind
bench_port.py (bfs_packed.py, K9-K12).  On the host, as in falkordb_tpu:
label propagation, MSF, maxFlow, the path enumerations and the native
direction-optimising BFS."""
