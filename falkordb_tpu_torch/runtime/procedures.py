"""Procedure registry (reference: runtime/functions/procedures.rs +
algo_procedures.rs).  A procedure is a generator of dict records keyed by
yield names."""

from __future__ import annotations

import numpy as np

PROCEDURES: dict = {}


def proc(name, yields):
    def deco(f):
        f.yields = yields
        PROCEDURES[name.lower()] = f
        return f
    return deco


@proc("db.labels", ["label"])
def db_labels(rt):
    for name in rt.store.schema.labels.names:
        yield {"label": name}


@proc("db.relationshiptypes", ["relationshipType"])
def db_reltypes(rt):
    for name in rt.store.schema.reltypes.names:
        yield {"relationshipType": name}


@proc("db.propertykeys", ["propertyKey"])
def db_propkeys(rt):
    for name in rt.store.schema.attrs.names:
        yield {"propertyKey": name}


@proc("db.meta.stats", ["labelCount", "relationshipTypeCount", "nodeCount",
                        "relationshipCount", "propertyKeyCount"])
def db_meta_stats(rt):
    g = rt.store
    yield {
        "labelCount": len(g.schema.labels),
        "relationshipTypeCount": len(g.schema.reltypes),
        "nodeCount": g.node_count,
        "relationshipCount": g.edge_count,
        "propertyKeyCount": len(g.schema.attrs),
    }


@proc("dbms.functions", ["name"])
def dbms_functions(rt):
    from falkordb_tpu_torch.runtime.functions import FUNCTIONS

    for name in sorted(FUNCTIONS):
        if name.startswith("_"):    # internal helpers are not user-facing
            continue
        yield {"name": name}


@proc("dbms.procedures", ["name", "mode"])
def dbms_procedures(rt):
    for name in sorted(PROCEDURES):
        yield {"name": name, "mode": "READ"}


# Index/algorithm procedures are registered by their subsystems at import
# time (falkordb_tpu_torch.algos.procedures, falkordb_tpu_torch.index.procedures).
