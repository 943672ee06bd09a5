"""Cypher value model + comparison/ordering semantics.

The reference's Value enum (graph/src/runtime/value.rs:180-215) and its
openCypher comparison rules.  Values are Python-native where possible
(None/bool/int/float/str/list/dict) plus entity wrappers; device code never
sees these — columns lower to typed arrays before touching XLA.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


class NodeVal:
    __slots__ = ("id", "labels", "properties")

    def __init__(self, id: int, labels=None, properties=None):
        self.id = id
        self.labels = labels or []
        self.properties = properties or {}

    def __eq__(self, other):
        return isinstance(other, NodeVal) and other.id == self.id

    def __hash__(self):
        return hash(("node", self.id))

    def __repr__(self):
        return f"Node(id={self.id}, labels={self.labels}, properties={self.properties})"


class EdgeVal:
    __slots__ = ("id", "relation", "src_node", "dst_node", "properties")

    def __init__(self, id: int, relation: str = "", src_node: int = -1,
                 dst_node: int = -1, properties=None):
        self.id = id
        self.relation = relation
        self.src_node = src_node
        self.dst_node = dst_node
        self.properties = properties or {}

    def __eq__(self, other):
        return isinstance(other, EdgeVal) and other.id == self.id

    def __hash__(self):
        return hash(("edge", self.id))

    def __repr__(self):
        return (f"Edge(id={self.id}, relation={self.relation!r}, "
                f"src={self.src_node}, dst={self.dst_node}, "
                f"properties={self.properties})")


class PathVal:
    __slots__ = ("nodes", "edges")

    def __init__(self, nodes, edges):
        self.nodes = list(nodes)
        self.edges = list(edges)

    def __eq__(self, other):
        return (isinstance(other, PathVal) and other.nodes == self.nodes
                and other.edges == self.edges)

    def __hash__(self):
        return hash(("path", tuple(n.id for n in self.nodes),
                     tuple(e.id for e in self.edges)))

    def __len__(self):
        return len(self.edges)

    def __repr__(self):
        return f"Path(nodes={len(self.nodes)}, edges={len(self.edges)})"


class PointVal:
    __slots__ = ("latitude", "longitude")

    def __init__(self, latitude: float, longitude: float):
        self.latitude = float(latitude)
        self.longitude = float(longitude)

    def __eq__(self, other):
        return (isinstance(other, PointVal)
                and other.latitude == self.latitude
                and other.longitude == self.longitude)

    def __hash__(self):
        return hash(("point", self.latitude, self.longitude))

    def __repr__(self):
        return f"Point(lat={self.latitude}, lon={self.longitude})"


class VectorF32:
    __slots__ = ("data",)

    def __init__(self, data):
        self.data = np.asarray(data, dtype=np.float32)

    def __eq__(self, other):
        return isinstance(other, VectorF32) and np.array_equal(other.data, self.data)

    def __hash__(self):
        return hash(("vecf32", self.data.tobytes()))

    def __repr__(self):
        return f"VectorF32({self.data.tolist()})"


# --------------------------------------------------------------- type order
# openCypher orderability: Map > Node > Edge > List > Path > String > Boolean
# > Number > NULL (we follow the reference's value.rs ordering for mixed-type
# ORDER BY; NULL sorts last ascending).

def _type_rank(v) -> int:
    if isinstance(v, dict):
        return 0
    if isinstance(v, NodeVal):
        return 1
    if isinstance(v, EdgeVal):
        return 2
    if isinstance(v, (list, tuple, VectorF32)):
        return 3
    if isinstance(v, PathVal):
        return 4
    if isinstance(v, str):
        return 5
    if isinstance(v, bool):
        return 6
    if isinstance(v, (int, float)):
        return 7
    if isinstance(v, PointVal):
        return 8
    if v is None:
        return 9
    return 8


def is_null(v) -> bool:
    return v is None


def equals(a, b):
    """Cypher `=`: returns True/False/None (null-propagating)."""
    if a is None or b is None:
        return None
    if isinstance(a, bool) or isinstance(b, bool):
        if isinstance(a, bool) and isinstance(b, bool):
            return a == b
        return False
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        # Python's == across int/float is EXACT (no rounding through
        # float), which is what Cypher requires for large ints
        # (TCK Comparison1 [12]/[13]); NaN = anything is False
        return a == b
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return False
        saw_null = False
        for x, y in zip(a, b):
            e = equals(x, y)
            if e is None:
                saw_null = True
            elif not e:
                return False
        return None if saw_null else True
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return False
        saw_null = False
        for k in a:
            e = equals(a[k], b[k])
            if e is None:
                saw_null = True
            elif not e:
                return False
        return None if saw_null else True
    if type(a) is not type(b) and not (
        isinstance(a, (NodeVal, EdgeVal, PathVal, PointVal, VectorF32))
        and type(a) is type(b)
    ):
        if isinstance(a, (int, float)) or isinstance(b, (int, float)):
            return False
        if type(a) is not type(b):
            return False
    return a == b


def compare(a, b) -> Optional[int]:
    """Three-way compare for <,<=,>,>=: None when incomparable (null or
    cross-type)."""
    if a is None or b is None:
        return None
    if isinstance(a, bool) and isinstance(b, bool):
        return (a > b) - (a < b)
    if isinstance(a, bool) or isinstance(b, bool):
        return None
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        if isinstance(a, float) and math.isnan(a) or isinstance(b, float) and math.isnan(b):
            # NaN comparisons are FALSE, not null (TCK Comparison2 [5]):
            # nan propagates so <,<=,>,>= on the result all yield False
            return math.nan
        return (a > b) - (a < b)
    if isinstance(a, str) and isinstance(b, str):
        return (a > b) - (a < b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        for x, y in zip(a, b):
            c = compare(x, y)
            if c is None:
                return None
            if c != 0:
                return c
        return (len(a) > len(b)) - (len(a) < len(b))
    # temporal values order naturally within their own type (TCK Temporal7;
    # note isinstance checks: datetime IS a date subclass, so match exact)
    import datetime as _dt

    if type(a) is type(b) and isinstance(
            a, (_dt.date, _dt.datetime, _dt.time, _dt.timedelta)):
        try:
            return (a > b) - (a < b)
        except TypeError:  # aware vs naive — incomparable
            return None
    return None


def order_key(v):
    """Total-order sort key for ORDER BY (nulls last, then type rank)."""
    r = _type_rank(v)
    if v is None:
        return (r, 0)
    if isinstance(v, bool):
        return (r, v)
    if isinstance(v, (int, float)):
        if isinstance(v, float) and math.isnan(v):
            return (r, (1, 0.0))
        return (r, (0, float(v)))
    if isinstance(v, str):
        return (r, v)
    if isinstance(v, (list, tuple)):
        return (r, tuple(order_key(x) for x in v))
    if isinstance(v, NodeVal):
        return (r, v.id)
    if isinstance(v, EdgeVal):
        return (r, v.id)
    if isinstance(v, PathVal):
        return (r, tuple(n.id for n in v.nodes))
    if isinstance(v, dict):
        return (r, tuple(sorted((k, order_key(x)) for k, x in v.items())))
    if isinstance(v, PointVal):
        return (r, (v.latitude, v.longitude))
    if isinstance(v, VectorF32):
        return (r, tuple(v.data.tolist()))
    return (r, str(v))


def truthy(v) -> Optional[bool]:
    """Cypher boolean coercion for predicates: null stays null."""
    if v is None:
        return None
    if isinstance(v, bool):
        return v
    # non-boolean predicate results are a type error in strict Cypher;
    # the reference treats them as an error, we coerce conservatively
    raise TypeError(f"expected Boolean, got {type(v).__name__}")


def and3(a, b):
    if a is False or b is False:
        return False
    if a is None or b is None:
        return None
    return True


def or3(a, b):
    if a is True or b is True:
        return True
    if a is None or b is None:
        return None
    return False


def xor3(a, b):
    if a is None or b is None:
        return None
    return bool(a) != bool(b)


def not3(a):
    if a is None:
        return None
    return not a
