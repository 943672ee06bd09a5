"""Graph algorithms.  This slice ports the compact adjacency snapshots
(common.py) and the single-source BFS levels that shortestPath runs
(bfs.py, kernel K4); the procedures and the other algorithms wait for
ROADMAP.md module 7."""
