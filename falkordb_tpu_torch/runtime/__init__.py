"""L4' — vectorized query runtime.

Batch operators over columnar row frames (the reference's 1024-row batch
pipeline, graph/src/runtime/batch.rs:81), with traversal expansion and
numeric filtering on device and scalar/string paths vectorized host-side.
"""
