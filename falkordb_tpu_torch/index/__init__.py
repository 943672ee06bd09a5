"""L3' — indexes: range (sorted-column), fulltext (inverted index).
The vector index waits for ROADMAP.md module 4.  Reference:
graph/src/index/."""
