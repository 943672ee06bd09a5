"""Graph algorithms: the compact adjacency snapshots (common.py), the
algo.* procedures (procedures.py) and what they run.  On the card: BFS
levels (bfs.py, kernel K4) and BFS with parents (K8), PageRank (K5), WCC
and SSSP (K6), betweenness (K7).  On the host, as in falkordb_tpu: label
propagation, MSF, maxFlow, the path enumerations and the native
direction-optimising BFS.  Harmonic centrality waits for the multi-source
BFS kernel (ROADMAP.md module 7)."""
