"""UDF subsystem (reference: graph/src/udf/ — QuickJS JavaScript libraries).

Here UDF libraries are Python modules executed in a restricted namespace
with a `falkor` helper object (`falkor.register`, `falkor.log`).  Functions
are invoked from Cypher as `LibName.FnName(args...)`
(tests/flow/test_udf.py:107).  Libraries are database-global, versioned
(plan caches key on the version), and persisted with checkpoints (the
RDB AUX field role, src/redis_type.rs:24-30).

Trust model: the reference sandboxes untrusted JS in QuickJS with
heap/stack/timeout limits; Python exec is not a sandbox, so UDF loading
here is an administrative operation (same trust level as installing a
plugin)."""

from falkordb_tpu_torch.udf.repository import UdfRepository, UdfError  # noqa: F401
