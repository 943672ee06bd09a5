"""Public embedded API — mirrors the falkordb-py client surface.

The reference is driven through Redis commands (GRAPH.QUERY et al.,
src/lib.rs:69-96); this framework is its own host, so the primary surface is
an embedded client: `FalkorDB().select_graph(name).query(cypher)`.

Every graph of a FalkorDB lives on one torch device: `device=None` means
the CUDA card, and a host without CUDA raises unless the caller asks for
`device="cpu"` (where the kernels' plain PyTorch versions run).
"""

from __future__ import annotations

from typing import Any, Optional


def resolve_device(device=None):
    """The torch device a database runs on: `None` means CUDA.  Raises
    when CUDA is asked for (or implied) and absent — the port never
    carries on quietly on the host."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "falkordb_tpu_torch runs on a CUDA device and none is available; "
            "pass device=\"cpu\" to run the plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class QueryResult:
    """Result set + statistics (the reference's ResultSummary,
    graph/src/runtime/runtime.rs:494)."""

    def __init__(self, header, rows, stats, profile=None):
        self.header = list(header)
        self.result_set = rows
        self.stats = dict(stats)
        self.profile = profile
        self.cached = False  # plan-cache hit ("Cached execution" footer)

    # falkordb-py compatible statistics accessors
    @property
    def nodes_created(self):
        return self.stats.get("nodes_created", 0)

    @property
    def nodes_deleted(self):
        return self.stats.get("nodes_deleted", 0)

    @property
    def relationships_created(self):
        return self.stats.get("relationships_created", 0)

    @property
    def relationships_deleted(self):
        return self.stats.get("relationships_deleted", 0)

    @property
    def properties_set(self):
        return self.stats.get("properties_set", 0)

    @property
    def labels_added(self):
        return self.stats.get("labels_added", 0)

    @property
    def indices_created(self):
        return self.stats.get("indices_created", 0)

    @property
    def indices_deleted(self):
        return self.stats.get("indices_deleted", 0)

    @property
    def run_time_ms(self):
        return self.stats.get("run_time_ms", 0.0)

    def __iter__(self):
        return iter(self.result_set)

    def __len__(self):
        return len(self.result_set)


class Graph:
    """Handle on one named graph (the reference's ThreadedGraph,
    src/graph_core.rs:362)."""

    def __init__(self, db: "FalkorDB", name: str):
        self._db = db
        self.name = name

    def _core(self):
        return self._db._get_or_create(self.name)

    def query(self, q: str, params: Optional[dict] = None, timeout: Optional[int] = None,
              read_only: bool = False) -> QueryResult:
        return self._core().query(q, params=params, timeout=timeout,
                                  read_only=read_only)

    def ro_query(self, q: str, params: Optional[dict] = None,
                 timeout: Optional[int] = None) -> QueryResult:
        return self.query(q, params=params, timeout=timeout, read_only=True)

    def explain(self, q: str, params: Optional[dict] = None) -> str:
        return self._core().explain(q, params=params)

    def profile(self, q: str, params: Optional[dict] = None) -> QueryResult:
        return self._core().query(q, params=params, profile=True)

    def delete(self) -> None:
        self._db._delete(self.name)

    def slowlog(self):
        return self._core().slowlog.entries()

    def memory_usage(self):
        return self._core().memory_usage()

    def constraints(self):
        return self._core().list_constraints()

    def create_constraint(self, ctype, entity, label, properties):
        return self._core().create_constraint(ctype, entity, label, properties)

    def drop_constraint(self, ctype, entity, label, properties):
        return self._core().drop_constraint(ctype, entity, label, properties)

    def copy(self, dest: str) -> "Graph":
        self._db._copy(self.name, dest)
        return Graph(self._db, dest)

    def bulk_insert(self, nodes=None, edges=None) -> dict:
        """Vectorized bulk load (GRAPH.BULK role).  See graph/bulk.py."""
        from falkordb_tpu_torch.graph.bulk import bulk_insert

        return bulk_insert(self._core(), nodes=nodes, edges=edges)

    def record(self, q: str, params: Optional[dict] = None) -> list:
        return self._core().record(q, params=params)


class FalkorDB:
    """The multi-tenant database host (GRAPH_REGISTRY, src/graph_core.rs:80)."""

    def __init__(self, config: Optional[dict] = None,
                 aof_dir: Optional[str] = None, device=None):
        import threading

        from falkordb_tpu_torch.core import GraphCore, GlobalConfig
        from falkordb_tpu_torch.udf import UdfRepository

        # every graph store of this database lives on this device
        self.device = resolve_device(device)
        self.config = GlobalConfig(**(config or {}))
        self._graphs: dict[str, Any] = {}
        self._GraphCore = GraphCore
        # per-graph append-only write logs for crash recovery (AOF role,
        # persist/aof.py); None = durability via explicit save() only
        self.aof_dir = aof_dir
        # UDF libraries are database-global (reference: udf/repository.rs)
        self.udfs = UdfRepository(
            timeout_s=self.config.udf_timeout_ms / 1000.0)
        # guards the graph registry against concurrent auto-creation
        # (the reference's GRAPH_REGISTRY lock, src/graph_core.rs:80)
        self._registry_lock = threading.Lock()

    def select_graph(self, name: str) -> Graph:
        return Graph(self, name)

    def list_graphs(self) -> list[str]:
        return sorted(self._graphs)

    def _get_or_create(self, name: str):
        core = self._graphs.get(name)
        if core is None:
            with self._registry_lock:
                core = self._graphs.get(name)
                if core is None:
                    core = self._GraphCore(name, self.config, udfs=self.udfs,
                                           device=self.device)
                    if self.aof_dir is not None:
                        import os

                        from falkordb_tpu_torch.persist.aof import EffectsLog

                        core.attach_aof(EffectsLog(
                            os.path.join(self.aof_dir, f"{name}.aof")))
                    self._graphs[name] = core
        return core

    def _delete(self, name: str) -> None:
        self._graphs.pop(name, None)

    def _copy(self, src: str, dest: str) -> None:
        if dest in self._graphs:
            raise ValueError(f"graph {dest!r} already exists")
        self._graphs[dest] = self._get_or_create(src).copy_as(dest)

    # UDF management (GRAPH.UDF LOAD/DELETE/FLUSH/LIST, src/commands/udf.rs)
    def udf_load(self, name: str, code: str, replace: bool = False):
        return self.udfs.load(name, code, replace)

    def udf_delete(self, name: str) -> None:
        self.udfs.delete(name)

    def udf_flush(self) -> None:
        self.udfs.flush()

    def udf_list(self, lib: Optional[str] = None, with_code: bool = False):
        return self.udfs.list(lib, with_code)

    # persistence -------------------------------------------------------------
    def save(self, path: str) -> None:
        from falkordb_tpu_torch.persist.checkpoint import save_db

        save_db(self, path)
        # the checkpoint now covers everything; restart the write logs
        for core in self._graphs.values():
            if core.aof is not None:
                core.aof.reset()

    @staticmethod
    def load(path: str, aof_dir: Optional[str] = None,
             device=None) -> "FalkorDB":
        """Recover from a checkpoint onto `device` (as in the constructor);
        with aof_dir, additionally replay the per-graph write logs on top
        (crash recovery = checkpoint + suffix replay, the reference's
        RDB+AOF combination).  Checkpoints written by falkordb_tpu's
        `FalkorDB.save` load the same way."""
        from falkordb_tpu_torch.persist.checkpoint import load_db

        db = load_db(path, device=device)
        if aof_dir is not None:
            import os

            from falkordb_tpu_torch.persist.aof import EffectsLog

            if os.path.isdir(aof_dir):
                for fn in sorted(os.listdir(aof_dir)):
                    if fn.endswith(".aof"):
                        # cores have no aof attached yet, so replayed
                        # writes do not re-append to the log
                        EffectsLog.replay(os.path.join(aof_dir, fn),
                                          db._get_or_create(fn[:-4]))
            db.aof_dir = aof_dir
            for name, core in db._graphs.items():
                core.attach_aof(EffectsLog(
                    os.path.join(aof_dir, f"{name}.aof")))
        return db
