"""L3' — indexes: range (sorted-column), fulltext (inverted index), vector
(exact / IVF, kernels K13-K15 on the device).  Reference:
graph/src/index/."""
