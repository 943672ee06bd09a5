"""Range index — sorted column arrays with delta maintenance.

The reference maintains RediSearch NUMERIC/TAG/GEO fields per indexed
property and updates documents incrementally on commit
(graph/src/index/mod.rs doc:8-15, graph/src/graph/graph.rs:337-420); its
composite indexes answer multi-property predicates with one scan
(planner/optimizer/utilize_index.rs).

TPU-first incarnation: per property a `SortedField` of dense sorted arrays
(binary-searchable, vectorizable, no pointers) plus a small *pending* delta
buffer and a *dead* tombstone set — per-write maintenance is O(log n +
|pending|) instead of an O(n) rebuild, and pending merges back into the
base when it crosses MERGE_THRESHOLD (the delta-matrix flush idea applied
to indexes).  Composite queries intersect per-property id sets
(np.intersect1d).  Point-typed properties are mirrored into lat/lon arrays
for `distance(n.p, point(...)) < r` index scans (geo role of RediSearch)."""

from __future__ import annotations

import math

import numpy as np

from falkordb_tpu_torch.graph.attrstore import ABSENT
from falkordb_tpu_torch.runtime.value import PointVal

MERGE_THRESHOLD = 1024
_EARTH_R = 6378140.0  # must match runtime/functions.py distance()


class SortedField:
    """One property's index: sorted numeric + string arrays, delta layer."""

    def __init__(self):
        self.num_vals = np.zeros(0, np.float64)
        self.num_ids = np.zeros(0, np.int64)
        self.str_vals = np.zeros(0, object)
        self.str_ids = np.zeros(0, np.int64)
        # geo mirror (PointVal properties)
        self.geo_ids = np.zeros(0, np.int64)
        self.geo_lat = np.zeros(0, np.float64)
        self.geo_lon = np.zeros(0, np.float64)
        # delta layer
        self.pend_num: list = []  # (value, id)
        self.pend_str: list = []
        self.pend_geo: list = []  # (id, lat, lon)
        self.dead: set[int] = set()

    # ---------------------------------------------------------- maintenance

    def load(self, values_ids):
        nums, nids, strs, sids, gids, glat, glon = [], [], [], [], [], [], []
        for v, i in values_ids:
            if isinstance(v, bool) or v is None or v is ABSENT:
                continue
            if isinstance(v, (int, float, np.integer, np.floating)):
                nums.append(float(v))
                nids.append(int(i))
            elif isinstance(v, str):
                strs.append(v)
                sids.append(int(i))
            elif isinstance(v, PointVal):
                gids.append(int(i))
                glat.append(v.latitude)
                glon.append(v.longitude)
        if nums:
            order = np.argsort(nums, kind="stable")
            self.num_vals = np.asarray(nums, np.float64)[order]
            self.num_ids = np.asarray(nids, np.int64)[order]
        if strs:
            order = np.argsort(strs, kind="stable")
            self.str_vals = np.asarray(strs, object)[order]
            self.str_ids = np.asarray(sids, np.int64)[order]
        if gids:
            self.geo_ids = np.asarray(gids, np.int64)
            self.geo_lat = np.asarray(glat, np.float64)
            self.geo_lon = np.asarray(glon, np.float64)

    def remove(self, eid: int):
        eid = int(eid)
        self.dead.add(eid)
        # purge any not-yet-merged pending entries for this id — lookups
        # include the pending buffer WITHOUT tombstone filtering, so a
        # stale (old_value, id) pair here would resurrect the old value
        # (bug surfaced when small graphs started taking the delta path)
        if self.pend_num:
            self.pend_num = [(v, i) for v, i in self.pend_num if i != eid]
        if self.pend_str:
            self.pend_str = [(v, i) for v, i in self.pend_str if i != eid]
        if self.pend_geo:
            self.pend_geo = [t for t in self.pend_geo if t[0] != eid]

    def add(self, eid: int, v):
        if isinstance(v, bool) or v is None or v is ABSENT:
            return
        if isinstance(v, (int, float, np.integer, np.floating)):
            self.pend_num.append((float(v), int(eid)))
        elif isinstance(v, str):
            self.pend_str.append((v, int(eid)))
        elif isinstance(v, PointVal):
            self.pend_geo.append((int(eid), v.latitude, v.longitude))
        if (len(self.pend_num) + len(self.pend_str) + len(self.pend_geo)
                > MERGE_THRESHOLD or len(self.dead) > MERGE_THRESHOLD):
            self.compact()

    def compact(self):
        """Merge pending into the sorted base, drop tombstones."""
        def alive(ids):
            return ~np.isin(ids, np.fromiter(self.dead, np.int64,
                                             len(self.dead)))
        if self.dead.intersection(self.num_ids.tolist()) or self.pend_num:
            keep = alive(self.num_ids) if len(self.num_ids) else \
                np.zeros(0, bool)
            vals = list(self.num_vals[keep]) + [v for v, _ in self.pend_num]
            ids = list(self.num_ids[keep]) + [i for _, i in self.pend_num]
            order = np.argsort(vals, kind="stable") if vals else []
            self.num_vals = np.asarray(vals, np.float64)[order]
            self.num_ids = np.asarray(ids, np.int64)[order]
        if self.dead.intersection(self.str_ids.tolist()) or self.pend_str:
            keep = alive(self.str_ids) if len(self.str_ids) else \
                np.zeros(0, bool)
            vals = list(self.str_vals[keep]) + [v for v, _ in self.pend_str]
            ids = list(self.str_ids[keep]) + [i for _, i in self.pend_str]
            order = np.argsort(vals, kind="stable") if vals else []
            self.str_vals = np.asarray(vals, object)[order]
            self.str_ids = np.asarray(ids, np.int64)[order]
        if self.dead.intersection(self.geo_ids.tolist()) or self.pend_geo:
            keep = alive(self.geo_ids) if len(self.geo_ids) else \
                np.zeros(0, bool)
            ids = list(self.geo_ids[keep]) + [i for i, _, _ in self.pend_geo]
            lat = list(self.geo_lat[keep]) + [a for _, a, _ in self.pend_geo]
            lon = list(self.geo_lon[keep]) + [o for _, _, o in self.pend_geo]
            self.geo_ids = np.asarray(ids, np.int64)
            self.geo_lat = np.asarray(lat, np.float64)
            self.geo_lon = np.asarray(lon, np.float64)
        self.pend_num, self.pend_str, self.pend_geo = [], [], []
        self.dead = set()

    # --------------------------------------------------------------- lookup

    def _filter_dead(self, ids):
        if not self.dead:
            return ids
        return ids[~np.isin(ids, np.fromiter(self.dead, np.int64,
                                             len(self.dead)))]

    def range_numeric(self, lo=-np.inf, hi=np.inf, lo_inc=True, hi_inc=True):
        l = np.searchsorted(self.num_vals, lo,
                            side="left" if lo_inc else "right")
        r = np.searchsorted(self.num_vals, hi,
                            side="right" if hi_inc else "left")
        ids = self._filter_dead(self.num_ids[l:r])
        if self.pend_num:
            extra = [i for v, i in self.pend_num
                     if (v >= lo if lo_inc else v > lo)
                     and (v <= hi if hi_inc else v < hi)]
            if extra:
                ids = np.concatenate([ids, np.asarray(extra, np.int64)])
        return ids

    def range_string(self, lo=None, hi=None, lo_inc=True, hi_inc=True):
        vals = self.str_vals
        l = 0 if lo is None else np.searchsorted(
            vals, lo, side="left" if lo_inc else "right")
        r = len(vals) if hi is None else np.searchsorted(
            vals, hi, side="right" if hi_inc else "left")
        ids = self._filter_dead(self.str_ids[l:r])
        if self.pend_str:
            extra = [i for v, i in self.pend_str
                     if (lo is None or (v >= lo if lo_inc else v > lo))
                     and (hi is None or (v <= hi if hi_inc else v < hi))]
            if extra:
                ids = np.concatenate([ids, np.asarray(extra, np.int64)])
        return ids

    def geo_within(self, center: PointVal, radius_m: float):
        """ids whose point lies within ~radius_m of center (haversine).
        Slightly padded SUPERSET — the planner keeps the distance()
        conjunct as a residual filter for exact boundary semantics."""
        radius_m = radius_m * (1 + 1e-12) + 1e-9
        ids = np.concatenate([
            self.geo_ids,
            np.asarray([i for i, _, _ in self.pend_geo], np.int64)])
        lat = np.concatenate([
            self.geo_lat,
            np.asarray([a for _, a, _ in self.pend_geo], np.float64)])
        lon = np.concatenate([
            self.geo_lon,
            np.asarray([o for _, _, o in self.pend_geo], np.float64)])
        if not len(ids):
            return ids
        la1 = math.radians(center.latitude)
        lo1 = math.radians(center.longitude)
        la2 = np.radians(lat)
        lo2 = np.radians(lon)
        h = (np.sin((la2 - la1) / 2) ** 2
             + math.cos(la1) * np.cos(la2) * np.sin((lo2 - lo1) / 2) ** 2)
        d = 2 * _EARTH_R * np.arcsin(np.sqrt(h))
        return self._filter_dead(ids[d < radius_m])

    def equals(self, v):
        if isinstance(v, str):
            return self.range_string(v, v)
        if isinstance(v, PointVal):
            ids = np.concatenate([
                self.geo_ids,
                np.asarray([i for i, _, _ in self.pend_geo], np.int64)])
            lat = np.concatenate([
                self.geo_lat,
                np.asarray([a for _, a, _ in self.pend_geo], np.float64)])
            lon = np.concatenate([
                self.geo_lon,
                np.asarray([o for _, _, o in self.pend_geo], np.float64)])
            return self._filter_dead(
                ids[(lat == v.latitude) & (lon == v.longitude)])
        return self.range_numeric(float(v), float(v))

    def memory_bytes(self):
        return (self.num_vals.nbytes + self.num_ids.nbytes
                + self.str_ids.nbytes + self.geo_ids.nbytes * 3
                + 16 * (len(self.pend_num) + len(self.pend_str)))


class RangeIndex:
    """Composite range index: one SortedField per property.

    Multi-property predicates intersect per-field id sets — the composite
    scan role of utilize_index.rs (equality prefix + range tail and
    IN-lists all reduce to per-field range unions + intersection)."""

    def __init__(self, props, entity, label):
        self.props = tuple(props)
        self.entity = entity
        self.label = label
        self.fields = {p: SortedField() for p in self.props}

    # -------------------------------------------------------------- build

    @staticmethod
    def _live_ids(store, d):
        lid = (store.schema.label_id(d.label) if d.entity == "node"
               else store.schema.reltype_id(d.label))
        if lid is None:
            return np.zeros(0, np.int64)
        if d.entity == "node":
            mask = store.label_masks.get(lid)
            if mask is None:
                return np.zeros(0, np.int64)
            return np.nonzero(mask[: store.node_max])[0]
        live = ~store.e_deleted[: store.edge_max]
        return np.nonzero((store.e_type[: store.edge_max] == lid) & live)[0]

    @staticmethod
    def build(store, d, ids=None) -> "RangeIndex":
        ix = RangeIndex(d.props, d.entity, d.label)
        ix.populate(store, d, ids)
        return ix

    def populate(self, store, d, ids=None):
        """(Re)load from a store snapshot; `ids` limits to a batch (the
        reference's 10K-batch background population cursor)."""
        if ids is None:
            ids = RangeIndex._live_ids(store, d)
        attrs = store.node_attrs if d.entity == "node" else store.edge_attrs
        for prop in self.props:
            aid = store.schema.attr_id(prop)
            col = attrs.columns.get(aid) if aid is not None else None
            if col is None:
                continue
            self.fields[prop].load(
                (col.data[i], i) for i in ids)

    # -------------------------------------------------------- maintenance

    def update(self, store, d, dirty_ids):
        """Apply a commit's delta: for each touched entity, retract its
        entries and re-add current values when it (still) matches the
        indexed label.  O(dirty · log n) — VERDICT r1 item 4."""
        lid = (store.schema.label_id(d.label) if d.entity == "node"
               else store.schema.reltype_id(d.label))
        attrs = store.node_attrs if d.entity == "node" else store.edge_attrs
        for eid in dirty_ids:
            eid = int(eid)
            alive = False
            if lid is not None:
                if d.entity == "node":
                    mask = store.label_masks.get(lid)
                    alive = (mask is not None and eid < len(mask)
                             and bool(mask[eid])
                             and bool(store.node_exists[eid]))
                else:
                    alive = (eid < store.edge_max
                             and not store.e_deleted[eid]
                             and int(store.e_type[eid]) == lid)
            for prop in self.props:
                f = self.fields[prop]
                f.remove(eid)
                if alive:
                    aid = store.schema.attr_id(prop)
                    col = attrs.columns.get(aid) if aid is not None else None
                    if col is not None:
                        f.add(eid, col.data[eid])

    # -------------------------------------------------------------- lookup

    def field(self, prop=None) -> SortedField:
        return self.fields[prop if prop is not None else self.props[0]]

    def seek(self, bounds_map) -> np.ndarray:
        """bounds_map: prop -> spec, where spec is
        ('range', lo, lo_inc, hi, hi_inc) | ('geo', center, radius) |
        ('in', values).  Returns the sorted intersection of per-field
        matches."""
        out = None
        for prop, spec in bounds_map.items():
            f = self.fields.get(prop)
            if f is None:
                return np.zeros(0, np.int64)
            if spec[0] == "geo":
                ids = f.geo_within(spec[1], spec[2])
            elif spec[0] == "in":
                vals = [v for v in (spec[1] or [])
                        if v is not None and not isinstance(v, bool)]
                parts = [f.equals(v) for v in vals]
                ids = (np.concatenate(parts) if parts
                       else np.zeros(0, np.int64))
            else:
                _, lo, lo_inc, hi, hi_inc = spec
                if isinstance(lo, str) or isinstance(hi, str):
                    ids = f.range_string(lo, hi, lo_inc, hi_inc)
                elif isinstance(lo, PointVal) or isinstance(hi, PointVal):
                    if (isinstance(lo, PointVal) and isinstance(hi, PointVal)
                            and lo == hi):
                        ids = f.equals(lo)
                    else:
                        return np.zeros(0, np.int64)
                else:
                    ids = f.range_numeric(
                        -np.inf if lo is None else float(lo),
                        np.inf if hi is None else float(hi), lo_inc, hi_inc)
            ids = np.unique(ids)
            out = ids if out is None else np.intersect1d(
                out, ids, assume_unique=True)
            if out is not None and not len(out):
                break
        return out if out is not None else np.zeros(0, np.int64)

    # legacy single-prop surface (procedures, existing callers)
    def range_numeric(self, *a, **kw):
        return self.field().range_numeric(*a, **kw)

    def range_string(self, *a, **kw):
        return self.field().range_string(*a, **kw)

    def equals(self, v):
        return self.field().equals(v)

    def memory_bytes(self):
        return sum(f.memory_bytes() for f in self.fields.values())
