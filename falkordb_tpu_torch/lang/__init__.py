"""L5' — openCypher front end: lexer → parser → AST → binder → planner.

Grammar semantics follow the reference's hand-written recursive descent
(graph/src/parser/cypher.rs:37-60 grammar sketch); the implementation is new.
"""

from falkordb_tpu_torch.lang.parser import parse  # noqa: F401
