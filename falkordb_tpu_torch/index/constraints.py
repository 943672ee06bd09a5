"""Constraints: UNIQUE and MANDATORY (reference: src/commands/constraint.rs +
graph/src/graph/constraint.rs).

Lifecycle matches the reference: CREATE registers the constraint
UNDER_CONSTRUCTION and replies PENDING; a background scan validates the
EXISTING data against a snapshot (MVCC makes the snapshot free) and flips
the status to OPERATIONAL, or deletes the constraint on violation
(status FAILED).  Writes arriving during construction are enforced
immediately — only the pre-existing data is scanned asynchronously."""

from __future__ import annotations

import threading

import numpy as np

from falkordb_tpu_torch.graph.attrstore import ABSENT


class ConstraintViolation(ValueError):
    pass


def _entities_of(store, entity, label):
    if entity.lower() in ("node", "nodes"):
        lid = store.schema.label_id(label)
        if lid is None:
            return np.zeros(0, dtype=np.int64), "node"
        m = store.label_masks.get(lid)
        return (np.nonzero(m[: store.node_max])[0]
                if m is not None else np.zeros(0, np.int64)), "node"
    tid = store.schema.reltype_id(label)
    if tid is None:
        return np.zeros(0, dtype=np.int64), "edge"
    live = ~store.e_deleted[: store.edge_max]
    return np.nonzero((store.e_type[: store.edge_max] == tid) & live)[0], "edge"


def validate_constraint(store, c) -> None:
    ents, kind = _entities_of(store, c["entity"], c["label"])
    attrs = store.node_attrs if kind == "node" else store.edge_attrs
    aids = [store.schema.attr_id(p) for p in c["properties"]]
    if c["type"] == "mandatory":
        for e in ents:
            for aid in aids:
                if aid is None or attrs.get(int(e), aid) in (ABSENT, None):
                    raise ConstraintViolation(
                        f"mandatory constraint violation: {c['label']} "
                        f"missing {c['properties']}")
    else:  # unique
        seen = {}
        for e in ents:
            key = []
            missing = False
            for aid in aids:
                v = attrs.get(int(e), aid) if aid is not None else ABSENT
                if v is ABSENT:
                    missing = True
                    break
                key.append(v if not isinstance(v, list) else tuple(v))
            if missing:
                continue
            k = tuple(key)
            if k in seen:
                raise ConstraintViolation(
                    f"unique constraint violation on {c['label']}"
                    f"({', '.join(c['properties'])})")
            seen[k] = int(e)


def create_constraint(core, ctype, entity, label, properties, sync=False):
    """Register UNDER_CONSTRUCTION and scan existing data in the background
    (constraint.rs Constraint_EnforceEntities on a detached thread).  The
    returned dict's "status" flips to OPERATIONAL / FAILED; `sync=True`
    (or config.delay_indexing falsy in tests wanting determinism) waits."""
    ctype = ctype.lower()
    if ctype not in ("unique", "mandatory"):
        raise ValueError("constraint type must be UNIQUE or MANDATORY")
    c = {"type": ctype, "entity": entity, "label": label,
         "properties": list(properties), "status": "UNDER_CONSTRUCTION"}
    for existing in core.constraints:
        if (existing["type"] == ctype and existing["label"] == label
                and existing["properties"] == c["properties"]
                and existing["entity"] == entity):
            raise ValueError("constraint already exists")
    core.constraints.append(c)
    return _launch_scan(core, c, sync)


# construction scans tracked OUTSIDE the constraint dicts — the dicts
# serialize verbatim into checkpoints/dumps (meta.json)
_SCANS: dict[int, threading.Thread] = {}


def _launch_scan(core, c, sync=False):
    snapshot = core.store  # immutable MVCC snapshot: scan needs no lock

    def scan():
        try:
            validate_constraint(snapshot, c)
        except ConstraintViolation as e:
            c["status"] = "FAILED"
            c["error"] = str(e)
            try:
                core.constraints.remove(c)  # failed constraints are dropped
            except ValueError:
                pass
            return
        finally:
            _SCANS.pop(id(c), None)
        if c["status"] == "UNDER_CONSTRUCTION":
            c["status"] = "OPERATIONAL"

    if sync:
        scan()
        if c["status"] == "FAILED":
            raise ConstraintViolation(c["error"])
        return c
    t = threading.Thread(target=scan, daemon=True,
                         name=f"constraint-scan-{c['label']}")
    _SCANS[id(c)] = t
    t.start()
    return c


def resume_scans(core):
    """Re-launch construction scans for constraints loaded mid-build
    (a checkpoint taken while UNDER_CONSTRUCTION persists that status)."""
    for c in list(core.constraints):
        if c.get("status") == "UNDER_CONSTRUCTION":
            _launch_scan(core, c)


def wait_all(core, timeout=10.0):
    """Join outstanding constraint-construction scans (tests/serializers)."""
    for c in list(core.constraints):
        t = _SCANS.get(id(c))
        if t is not None:
            t.join(timeout)


def drop_constraint(core, ctype, entity, label, properties):
    ctype = ctype.lower()
    for i, c in enumerate(core.constraints):
        if (c["type"] == ctype and c["label"] == label
                and c["properties"] == list(properties)
                and c["entity"] == entity):
            del core.constraints[i]
            return True
    raise ValueError("no such constraint")


def enforce_after_write(core, store) -> None:
    """Called before commit; raises (aborting the write) on violation.
    UNDER_CONSTRUCTION constraints enforce on new writes too — only the
    pre-existing scan runs in the background (constraint.rs pending
    semantics)."""
    for c in core.constraints:
        if c["status"] in ("OPERATIONAL", "UNDER_CONSTRUCTION"):
            validate_constraint(store, c)
