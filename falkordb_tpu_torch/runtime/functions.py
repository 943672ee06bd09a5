"""Built-in scalar function registry.

The reference registers 128 built-ins via cypher_fn! (graph/src/runtime/
functions/mod.rs); this module covers the same families: math/trig, string,
list, temporal, spatial, conversion, entity, path, vector, predicates,
random.  Aggregates live in the Aggregate operator; procedures in
procedures.py.  All functions are scalar-per-row with null-in/null-out
unless Cypher defines otherwise."""

from __future__ import annotations

import datetime as _dt
import json
import math
import random
import re
import uuid

import numpy as np

from falkordb_tpu_torch.runtime.value import (
    EdgeVal, NodeVal, PathVal, PointVal, VectorF32, equals, order_key,
)

FUNCTIONS: dict = {}


def fn(name, nulls_propagate=True):
    def deco(f):
        if nulls_propagate:
            def wrapper(ctx, *args):
                if any(a is None for a in args):
                    return None
                return f(ctx, *args)
            FUNCTIONS[name] = wrapper
        else:
            FUNCTIONS[name] = f
        return f
    return deco


_NUM = (int, float)


def _req_num(x, name):
    if isinstance(x, bool) or not isinstance(x, _NUM):
        raise ValueError(f"{name}() expects a number")
    return x


# ------------------------------------------------------------------- math

@fn("abs")
def _abs(ctx, x):
    return abs(_req_num(x, "abs"))

@fn("ceil")
def _ceil(ctx, x):
    return float(math.ceil(_req_num(x, "ceil")))

@fn("floor")
def _floor(ctx, x):
    return float(math.floor(_req_num(x, "floor")))

@fn("round")
def _round(ctx, x):
    return float(math.floor(_req_num(x, "round") + 0.5))

@fn("sign")
def _sign(ctx, x):
    x = _req_num(x, "sign")
    return (x > 0) - (x < 0)

@fn("sqrt")
def _sqrt(ctx, x):
    x = _req_num(x, "sqrt")
    return math.sqrt(x) if x >= 0 else math.nan

@fn("pow")
def _pow(ctx, a, b):
    return float(_req_num(a, "pow")) ** float(_req_num(b, "pow"))

@fn("exp")
def _exp(ctx, x):
    return math.exp(_req_num(x, "exp"))

@fn("log")
def _log(ctx, x):
    x = _req_num(x, "log")
    return math.log(x) if x > 0 else math.nan

@fn("log10")
def _log10(ctx, x):
    x = _req_num(x, "log10")
    return math.log10(x) if x > 0 else math.nan

@fn("sin")
def _sin(ctx, x):
    return math.sin(_req_num(x, "sin"))

@fn("cos")
def _cos(ctx, x):
    return math.cos(_req_num(x, "cos"))

@fn("tan")
def _tan(ctx, x):
    return math.tan(_req_num(x, "tan"))

@fn("cot")
def _cot(ctx, x):
    t = math.tan(_req_num(x, "cot"))
    return math.inf if t == 0 else 1.0 / t

@fn("asin")
def _asin(ctx, x):
    x = _req_num(x, "asin")
    return math.asin(x) if -1 <= x <= 1 else math.nan

@fn("acos")
def _acos(ctx, x):
    x = _req_num(x, "acos")
    return math.acos(x) if -1 <= x <= 1 else math.nan

@fn("atan")
def _atan(ctx, x):
    return math.atan(_req_num(x, "atan"))

@fn("atan2")
def _atan2(ctx, y, x):
    return math.atan2(_req_num(y, "atan2"), _req_num(x, "atan2"))

@fn("degrees")
def _degrees(ctx, x):
    return math.degrees(_req_num(x, "degrees"))

@fn("radians")
def _radians(ctx, x):
    return math.radians(_req_num(x, "radians"))

@fn("pi", nulls_propagate=False)
def _pi(ctx):
    return math.pi

@fn("e", nulls_propagate=False)
def _e(ctx):
    return math.e

@fn("rand", nulls_propagate=False)
def _rand(ctx):
    return random.random()

@fn("randomuuid", nulls_propagate=False)
def _randomuuid(ctx):
    return str(uuid.uuid4())

@fn("haversin")
def _haversin(ctx, x):
    return math.sin(_req_num(x, "haversin") / 2.0) ** 2


# ------------------------------------------------------------------ string

@fn("left")
def _left(ctx, s, n):
    if n < 0:
        raise ValueError("left() expects a non-negative length")
    return s[: int(n)]

@fn("right")
def _right(ctx, s, n):
    if n < 0:
        raise ValueError("right() expects a non-negative length")
    return s[-int(n):] if n else ""

@fn("ltrim")
def _ltrim(ctx, s):
    return s.lstrip()

@fn("rtrim")
def _rtrim(ctx, s):
    return s.rstrip()

@fn("trim")
def _trim(ctx, s):
    return s.strip()

@fn("tolower")
def _tolower(ctx, s):
    return s.lower()

@fn("toupper")
def _toupper(ctx, s):
    return s.upper()

@fn("reverse")
def _reverse(ctx, s):
    if isinstance(s, list):
        return list(reversed(s))
    return s[::-1]

@fn("split")
def _split(ctx, s, sep):
    if sep == "":
        return list(s)
    return s.split(sep)

@fn("substring")
def _substring(ctx, s, start, *length):
    start = int(start)
    if start < 0:
        raise ValueError("substring() start must be non-negative")
    if length:
        return s[start : start + int(length[0])]
    return s[start:]

@fn("replace")
def _replace(ctx, s, old, new):
    return s.replace(old, new)

@fn("size", nulls_propagate=False)
def _size(ctx, x):
    if x is None:
        return None
    if isinstance(x, (str, list, tuple)):
        return len(x)
    if isinstance(x, VectorF32):
        return int(x.data.shape[0])
    raise ValueError("size() expects a string or list")

@fn("string.join")
def _string_join(ctx, parts, *sep):
    s = sep[0] if sep else ""
    return s.join(parts)

@fn("string.matchregex")
def _match_regex(ctx, s, pat):
    return [list(m.groups()) if m.groups() else [m.group(0)]
            for m in re.finditer(pat, s)]

@fn("string.replaceregex")
def _replace_regex(ctx, s, pat, rep):
    return re.sub(pat, rep, s)

@fn("intern")
def _intern(ctx, s):
    import sys
    return sys.intern(s) if isinstance(s, str) else s


# -------------------------------------------------------------------- list

def _int_arg(fname, x):
    """Strict integer argument: bool/float/other → ArgumentError
    (TCK List11 [5]: range() rejects non-integer argument types)."""
    if isinstance(x, bool) or not isinstance(x, int):
        raise ValueError(
            f"{fname}(): expected an integer argument, got {type(x).__name__}")
    return x


@fn("range")
def _range(ctx, a, b, *step):
    st = _int_arg("range", step[0]) if step else 1
    if st == 0:
        raise ValueError("range() step cannot be 0")
    a = _int_arg("range", a)
    b = _int_arg("range", b)
    return list(range(a, b + (1 if st > 0 else -1), st))

@fn("head")
def _head(ctx, l):
    return l[0] if l else None

@fn("last")
def _last(ctx, l):
    return l[-1] if l else None

@fn("tail")
def _tail(ctx, l):
    return list(l[1:])

@fn("list.dedup")
def _dedup(ctx, l):
    seen = []
    out = []
    for x in l:
        if not any(equals(x, s) is True for s in seen):
            seen.append(x)
            out.append(x)
    return out

@fn("list.insert")
def _linsert(ctx, l, idx, v, *dups):
    l = list(l)
    idx = int(idx)
    if idx < 0:
        idx += len(l) + 1
    allow_dups = dups[0] if dups else True
    if not allow_dups and any(equals(v, x) is True for x in l):
        return l
    if 0 <= idx <= len(l):
        l.insert(idx, v)
    return l

@fn("list.insertlistelements")
def _linsertlist(ctx, l, other, idx, *dups):
    l = list(l)
    idx = int(idx)
    if idx < 0:
        idx += len(l) + 1
    if not (0 <= idx <= len(l)):
        return l
    allow = dups[0] if dups else True
    add = [v for v in other if allow or not any(equals(v, x) is True for x in l)]
    return l[:idx] + add + l[idx:]

@fn("list.remove")
def _lremove(ctx, l, idx, *count):
    l = list(l)
    idx = int(idx)
    if idx < 0:
        idx += len(l)
    c = int(count[0]) if count else 1
    if 0 <= idx < len(l) and c > 0:
        del l[idx : idx + c]
    return l

@fn("list.sort")
def _lsort(ctx, l, *asc):
    ascending = asc[0] if asc else True
    return sorted(l, key=order_key, reverse=not ascending)

@fn("list.unique")
def _lunique(ctx, l):
    return FUNCTIONS["list.dedup"](ctx, l)


# ------------------------------------------------------------- conversion

def _conv_reject(fname, x, *extra_types):
    """Containers and graph entities are TYPE errors for the conversion
    functions (TCK TypeConversion1-4 'Fail on invalid types' —
    InvalidArgumentValue); only unparseable STRINGS convert to null."""
    if isinstance(x, (list, dict, NodeVal, EdgeVal, PathVal)) or \
            isinstance(x, extra_types):
        raise ValueError(
            f"{fname}(): invalid argument type {type(x).__name__}")


@fn("tointeger")
def _toint(ctx, x):
    _conv_reject("toInteger", x)
    if isinstance(x, bool):
        return 1 if x else 0
    if isinstance(x, int):
        return x
    if isinstance(x, float):
        if math.isnan(x) or math.isinf(x):
            return None
        return int(x)
    if isinstance(x, str):
        try:
            return int(x)
        except ValueError:
            try:
                f = float(x)
                return int(f)
            except ValueError:
                return None
    return None

@fn("tofloat")
def _tofloat(ctx, x):
    if isinstance(x, bool):
        raise ValueError("toFloat(): invalid argument type boolean")
    _conv_reject("toFloat", x)
    if isinstance(x, _NUM):
        return float(x)
    if isinstance(x, str):
        try:
            return float(x)
        except ValueError:
            return None
    return None

@fn("toboolean")
def _tobool(ctx, x):
    if isinstance(x, bool):
        return x
    _conv_reject("toBoolean", x, float)
    if isinstance(x, int):
        return bool(x)
    if isinstance(x, str):
        if x.lower() == "true":
            return True
        if x.lower() == "false":
            return False
        return None
    return None

@fn("tostring")
def _tostring(ctx, x):
    _conv_reject("toString", x)
    if isinstance(x, str):
        return x
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, int):
        return str(x)
    if isinstance(x, float):
        return repr(x)
    if isinstance(x, PointVal):
        return f"point({{latitude: {x.latitude}, longitude: {x.longitude}}})"
    # temporal serialization (TCK Temporal6: date(toString(d)) = d)
    if isinstance(x, (_dt.datetime, _dt.date, _dt.time)):
        return x.isoformat()
    if isinstance(x, _dt.timedelta):
        days, secs = x.days, x.seconds
        frac = x.microseconds
        out = "P"
        if days:
            out += f"{days}D"
        if secs or frac or not days:
            out += "T"
            h, rem = divmod(secs, 3600)
            m, s = divmod(rem, 60)
            if h:
                out += f"{h}H"
            if m:
                out += f"{m}M"
            if frac:
                out += f"{s + frac / 1e6:.6f}".rstrip("0") + "S"
            else:
                out += f"{s}S"
        return out
    return None

@fn("tostringornull")
def _tostringornull(ctx, x):
    try:
        return _tostring(ctx, x)
    except ValueError:  # OrNull variant: invalid types → null, not error
        return None

def _conv_list(ctx, l, inner):
    """List variants convert element-wise; inconvertible elements become
    null rather than erroring (graph/src/runtime/functions conversion
    list family)."""
    out = []
    for x in l:
        try:
            out.append(FUNCTIONS[inner](ctx, x))
        except ValueError:
            out.append(None)
    return out


@fn("tointegerlist")
def _tointlist(ctx, l):
    return _conv_list(ctx, l, "tointeger")

@fn("tofloatlist")
def _tofloatlist(ctx, l):
    return _conv_list(ctx, l, "tofloat")

@fn("tobooleanlist")
def _toboollist(ctx, l):
    return _conv_list(ctx, l, "toboolean")

@fn("tostringlist")
def _tostrlist(ctx, l):
    return _conv_list(ctx, l, "tostring")

def _jsonable(x):
    if isinstance(x, (NodeVal, EdgeVal)):
        return {"id": x.id, "properties": {k: _jsonable(v) for k, v in x.properties.items()},
                **({"labels": x.labels} if isinstance(x, NodeVal)
                   else {"relation": x.relation})}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, VectorF32):
        return x.data.tolist()
    return x

@fn("tojson")
def _tojson(ctx, x):
    return json.dumps(_jsonable(x))


# ----------------------------------------------------------------- entity

@fn("id")
def _id(ctx, x):
    if isinstance(x, (NodeVal, EdgeVal)):
        return x.id
    raise ValueError("id() expects a node or relationship")

@fn("labels")
def _labels(ctx, x):
    if isinstance(x, NodeVal):
        return list(x.labels)
    raise ValueError("labels() expects a node")

@fn("type")
def _type(ctx, x):
    if isinstance(x, EdgeVal):
        return x.relation
    raise ValueError("type() expects a relationship")

@fn("properties", nulls_propagate=False)
def _properties(ctx, x):
    if x is None:
        return None
    if isinstance(x, (NodeVal, EdgeVal)):
        return dict(x.properties)
    if isinstance(x, dict):
        return x
    raise ValueError("properties() expects an entity or map")

@fn("keys")
def _keys(ctx, x):
    if isinstance(x, (NodeVal, EdgeVal)):
        return sorted(x.properties.keys())
    if isinstance(x, dict):
        return sorted(x.keys())
    raise ValueError("keys() expects an entity or map")

@fn("startnode")
def _startnode(ctx, x):
    if isinstance(x, EdgeVal):
        return ctx.node_value(x.src_node)
    raise ValueError("startNode() expects a relationship")

@fn("endnode")
def _endnode(ctx, x):
    if isinstance(x, EdgeVal):
        return ctx.node_value(x.dst_node)
    raise ValueError("endNode() expects a relationship")

@fn("haslabels")
def _haslabels(ctx, x, labels):
    if isinstance(x, NodeVal):
        return all(l in x.labels for l in labels)
    raise ValueError("hasLabels() expects a node")

@fn("_reldistinct")
def _reldistinct(ctx, *rels):
    """Internal: relationship-uniqueness predicate for one MATCH pattern
    (openCypher edge isomorphism; the reference enforces it structurally
    in all_paths traversal).  Args are edges or edge lists (var-len);
    nulls (OPTIONAL misses) are ignored.  True iff all edge ids are
    pairwise distinct."""
    seen = set()
    for r in rels:
        if r is None:
            continue
        items = r if isinstance(r, (list, tuple)) else [r]
        for e in items:
            if e is None:
                continue
            eid = e.id if isinstance(e, EdgeVal) else e
            if eid in seen:
                return False
            seen.add(eid)
    return True

@fn("indegree")
def _indegree(ctx, x, *types):
    return _degree(ctx, x, types, "in")

@fn("outdegree")
def _outdegree(ctx, x, *types):
    return _degree(ctx, x, types, "out")

def _degree(ctx, x, types, direction):
    if not isinstance(x, NodeVal):
        raise ValueError("degree expects a node")
    g = ctx.store
    tids = []
    flat = []
    for t in types:
        flat.extend(t if isinstance(t, list) else [t])
    if flat:
        for t in flat:
            tid = g.schema.reltype_id(t)
            if tid is not None:
                tids.append(tid)
    else:
        tids = list(g.adj.keys())
    n = 0
    live = ~g.e_deleted[: g.edge_max]
    col = g.e_src if direction == "out" else g.e_dst
    for tid in tids:
        sel = (g.e_type[: g.edge_max] == tid) & live & (col[: g.edge_max] == x.id)
        n += int(np.sum(sel))
    return n


# ------------------------------------------------------------------- path

@fn("nodes")
def _nodes(ctx, p):
    if isinstance(p, PathVal):
        return list(p.nodes)
    raise ValueError("nodes() expects a path")

@fn("relationships")
def _relationships(ctx, p):
    if isinstance(p, PathVal):
        return list(p.edges)
    raise ValueError("relationships() expects a path")

@fn("length")
def _length(ctx, p):
    if isinstance(p, PathVal):
        return len(p.edges)
    raise ValueError("length() expects a path")

@fn("shortestpath")
def _shortestpath_fn(ctx, a, b):
    raise ValueError("shortestPath() must appear in a MATCH pattern")


# ---------------------------------------------------------------- spatial

@fn("point")
def _point(ctx, m):
    if not isinstance(m, dict):
        raise ValueError("point() expects a map")
    lat = m.get("latitude")
    lon = m.get("longitude")
    if lat is None or lon is None:
        raise ValueError("point() requires latitude and longitude")
    if not -90 <= lat <= 90 or not -180 <= lon <= 180:
        raise ValueError("point() coordinates out of range")
    return PointVal(lat, lon)

_EARTH_R = 6371_000.0  # metres

@fn("distance")
def _distance(ctx, a, b):
    if not isinstance(a, PointVal) or not isinstance(b, PointVal):
        raise ValueError("distance() expects two points")
    la1, lo1 = math.radians(a.latitude), math.radians(a.longitude)
    la2, lo2 = math.radians(b.latitude), math.radians(b.longitude)
    h = (math.sin((la2 - la1) / 2) ** 2
         + math.cos(la1) * math.cos(la2) * math.sin((lo2 - lo1) / 2) ** 2)
    return 2 * _EARTH_R * math.asin(math.sqrt(h))


# ----------------------------------------------------------------- vector

@fn("vecf32")
def _vecf32(ctx, l):
    if not isinstance(l, (list, tuple)):
        raise ValueError("vecf32() expects a list of numbers")
    return VectorF32(l)

@fn("vec.cosinedistance")
def _vcos(ctx, a, b):
    va = a.data if isinstance(a, VectorF32) else np.asarray(a, np.float32)
    vb = b.data if isinstance(b, VectorF32) else np.asarray(b, np.float32)
    na, nb = np.linalg.norm(va), np.linalg.norm(vb)
    if na == 0 or nb == 0:
        return 1.0
    return float(1.0 - np.dot(va, vb) / (na * nb))

@fn("vec.euclideandistance")
def _veuc(ctx, a, b):
    va = a.data if isinstance(a, VectorF32) else np.asarray(a, np.float32)
    vb = b.data if isinstance(b, VectorF32) else np.asarray(b, np.float32)
    return float(np.linalg.norm(va - vb))


# --------------------------------------------------------------- temporal

def _now_ms():
    return int(_dt.datetime.now(tz=_dt.timezone.utc).timestamp() * 1000)

@fn("timestamp", nulls_propagate=False)
def _timestamp(ctx):
    return _now_ms()

@fn("date", nulls_propagate=False)
def _date(ctx, *arg):
    if arg and arg[0] is not None:
        if isinstance(arg[0], str):
            return _dt.date.fromisoformat(arg[0])
        if isinstance(arg[0], dict):
            return _dt.date(int(arg[0].get("year", 1970)),
                            int(arg[0].get("month", 1)),
                            int(arg[0].get("day", 1)))
    return _dt.datetime.now(tz=_dt.timezone.utc).date()

@fn("datetime", nulls_propagate=False)
def _datetime(ctx, *arg):
    if arg and arg[0] is not None:
        if isinstance(arg[0], str):
            return _dt.datetime.fromisoformat(arg[0])
        if isinstance(arg[0], dict):
            m = arg[0]
            return _dt.datetime(
                int(m.get("year", 1970)), int(m.get("month", 1)),
                int(m.get("day", 1)), int(m.get("hour", 0)),
                int(m.get("minute", 0)), int(m.get("second", 0)),
                _usec_of(m))
    return _dt.datetime.now(tz=_dt.timezone.utc)

def _usec_of(m):
    """Sub-second map components -> microseconds (nanosecond precision
    truncates to Python's microsecond resolution)."""
    return (int(m.get("millisecond", 0)) * 1000
            + int(m.get("microsecond", 0))
            + int(m.get("nanosecond", 0)) // 1000)


def _time_of_map(m):
    return _dt.time(int(m.get("hour", 0)), int(m.get("minute", 0)),
                    int(m.get("second", 0)), _usec_of(m))


@fn("localtime", nulls_propagate=False)
def _localtime(ctx, *arg):
    if arg and arg[0] is not None:
        if isinstance(arg[0], str):
            return _dt.time.fromisoformat(arg[0])
        if isinstance(arg[0], dict):
            return _time_of_map(arg[0])
    return _dt.datetime.now().time()

@fn("localdatetime", nulls_propagate=False)
def _localdatetime(ctx, *arg):
    if arg and arg[0] is not None:
        if isinstance(arg[0], str):
            return _dt.datetime.fromisoformat(arg[0])
        if isinstance(arg[0], dict):
            m = arg[0]
            return _dt.datetime(
                int(m.get("year", 1970)), int(m.get("month", 1)),
                int(m.get("day", 1)), int(m.get("hour", 0)),
                int(m.get("minute", 0)), int(m.get("second", 0)),
                _usec_of(m))
    return _dt.datetime.now()

@fn("time", nulls_propagate=False)
def _time(ctx, *arg):
    if arg and arg[0] is not None:
        if isinstance(arg[0], str):
            return _dt.time.fromisoformat(arg[0])
        if isinstance(arg[0], dict):
            return _time_of_map(arg[0])
    return _dt.datetime.now(tz=_dt.timezone.utc).time()

@fn("duration")
def _duration(ctx, arg):
    """Anchored-encoding Duration (see runtime/temporal.py; mirrors
    /root/reference/graph/src/runtime/functions/temporal.rs:541
    duration_pure — calendar months survive, P1M + Jan 31 rolls)."""
    from .temporal import construct_duration, parse_duration
    if isinstance(arg, dict):
        return construct_duration(
            years=int(arg.get("years", 0)), months=int(arg.get("months", 0)),
            weeks=int(arg.get("weeks", 0)), days=int(arg.get("days", 0)),
            hours=int(arg.get("hours", 0)),
            minutes=int(arg.get("minutes", 0)),
            seconds=float(arg.get("seconds", 0)))
    if isinstance(arg, str):
        return parse_duration(arg)
    raise ValueError("duration() expects a map or string")


# ------------------------------------------------------------- predicates

@fn("coalesce", nulls_propagate=False)
def _coalesce(ctx, *args):
    for a in args:
        if a is not None:
            return a
    return None

@fn("isempty")
def _isempty(ctx, x):
    if isinstance(x, (str, list, tuple, dict)):
        return len(x) == 0
    raise ValueError("isEmpty() expects a string, list or map")

@fn("exists", nulls_propagate=False)
def _exists(ctx, x):
    return x is not None


@fn("_propsmatch")
def _propsmatch(ctx, ent, m):
    if not isinstance(m, dict):
        raise ValueError("inline properties must be a map")
    props = ent.properties if isinstance(ent, (NodeVal, EdgeVal)) else ent
    if not isinstance(props, dict):
        return False
    for k, v in m.items():
        if equals(props.get(k), v) is not True:
            return False
    return True


@fn("typeof", nulls_propagate=False)
def _typeof(ctx, x):
    if x is None:
        return "Null"
    if isinstance(x, bool):
        return "Boolean"
    if isinstance(x, int):
        return "Integer"
    if isinstance(x, float):
        return "Float"
    if isinstance(x, str):
        return "String"
    if isinstance(x, (list, tuple)):
        return "List"
    if isinstance(x, NodeVal):
        return "Node"
    if isinstance(x, EdgeVal):
        return "Edge"
    if isinstance(x, PathVal):
        return "Path"
    if isinstance(x, dict):
        return "Map"
    if isinstance(x, PointVal):
        return "Point"
    if isinstance(x, VectorF32):
        return "Vectorf32"
    import datetime as _d
    if isinstance(x, _d.datetime):
        return "Datetime"
    if isinstance(x, _d.date):
        return "Date"
    if isinstance(x, _d.time):
        return "Time"
    if isinstance(x, _d.timedelta):
        return "Duration"
    return type(x).__name__


# `.transaction` temporal variants: frozen at query start (the reference
# snapshots them per transaction; our queries are single transactions)
for _name in ("date", "datetime", "time", "localtime", "localdatetime",
              "timestamp"):
    FUNCTIONS[f"{_name}.transaction"] = FUNCTIONS[_name]
    FUNCTIONS[f"{_name}.statement"] = FUNCTIONS[_name]
    FUNCTIONS[f"{_name}.realtime"] = FUNCTIONS[_name]
