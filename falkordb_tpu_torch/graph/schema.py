"""Schema maps: label / relationship-type / attribute string↔id interning.

The reference keeps these in Graph (label_names/relation_names/attr maps,
graph/src/graph/graph.rs:258-320) with schema-version bumps invalidating the
plan cache (mvcc_graph.rs:122)."""

from __future__ import annotations


class _Interner:
    def __init__(self):
        self.names: list[str] = []
        self.ids: dict[str, int] = {}

    def get_or_add(self, name: str) -> int:
        i = self.ids.get(name)
        if i is None:
            i = len(self.names)
            self.names.append(name)
            self.ids[name] = i
        return i

    def get(self, name: str) -> int | None:
        return self.ids.get(name)

    def name(self, i: int) -> str:
        return self.names[i]

    def __len__(self):
        return len(self.names)

    def copy(self) -> "_Interner":
        c = _Interner.__new__(_Interner)
        c.names = list(self.names)
        c.ids = dict(self.ids)
        return c


class Schema:
    def __init__(self):
        self.labels = _Interner()
        self.reltypes = _Interner()
        self.attrs = _Interner()
        self.version = 0  # bumped on any schema addition (plan-cache key)

    def label_id(self, name: str, create: bool = False):
        if create:
            n = len(self.labels)
            i = self.labels.get_or_add(name)
            if len(self.labels) != n:
                self.version += 1
            return i
        return self.labels.get(name)

    def reltype_id(self, name: str, create: bool = False):
        if create:
            n = len(self.reltypes)
            i = self.reltypes.get_or_add(name)
            if len(self.reltypes) != n:
                self.version += 1
            return i
        return self.reltypes.get(name)

    def attr_id(self, name: str, create: bool = False):
        if create:
            n = len(self.attrs)
            i = self.attrs.get_or_add(name)
            if len(self.attrs) != n:
                self.version += 1
            return i
        return self.attrs.get(name)

    def copy(self) -> "Schema":
        s = Schema.__new__(Schema)
        s.labels = self.labels.copy()
        s.reltypes = self.reltypes.copy()
        s.attrs = self.attrs.copy()
        s.version = self.version
        return s
