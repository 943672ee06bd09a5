"""Versioned UDF library store (reference: graph/src/udf/repository.rs).

Loading executes the library source once; functions register through
`falkor.register(name, fn)`.  The repository version bumps on every
mutation so plan caches can invalidate (graph.rs:1095 doc:63-68)."""

from __future__ import annotations

import builtins
import ctypes
import heapq
import logging
import math
import threading
import time

logger = logging.getLogger("falkordb_tpu_torch.udf")


class UdfError(ValueError):
    pass


class UdfTimeout(UdfError):
    def __init__(self, msg: str = "UDF exceeded execution timeout"):
        super().__init__(msg)


class UdfMemoryExceeded(UdfError):
    def __init__(self, msg: str = "UDF exceeded memory limit"):
        super().__init__(msg)


def _rss_bytes() -> int:
    """Process resident set size (Linux /proc; 0 = unsupported)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * 4096
    except (OSError, ValueError, IndexError):
        return 0


class _Watchdog:
    """Shared deadline watchdog: raises UdfTimeout *inside* the thread
    running a UDF once its deadline passes (PyThreadState_SetAsyncExc —
    the CPython analogue of the reference's QuickJS interrupt handler,
    graph/src/udf/js_context.rs).  Only interrupts Python bytecode; a UDF
    blocked inside a single C call is not preemptible (documented limit)."""

    _MEM_POLL_S = 0.05

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._heap: list = []  # (deadline, token)
        # token -> (tid, rss_baseline, mem_cap_bytes | None)
        self._live: dict[int, tuple] = {}
        self._next = 0
        self._thread = None

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="udf-watchdog", daemon=True)
            self._thread.start()

    def register(self, timeout_s: float, mem_mb: float | None = None) -> int:
        tid = threading.get_ident()
        cap = None
        base = 0
        if mem_mb and mem_mb > 0:
            base = _rss_bytes()
            if base:
                cap = int(mem_mb * 1024 * 1024)
        with self._cv:
            self._ensure_thread()
            token = self._next
            self._next += 1
            self._live[token] = (tid, base, cap)
            heapq.heappush(self._heap, (time.monotonic() + timeout_s, token))
            self._cv.notify()
        return token

    def cancel(self, token: int) -> None:
        with self._cv:
            self._live.pop(token, None)

    def _run(self):
        while True:
            kill = None  # (tid, exc)
            with self._cv:
                while not self._heap:
                    self._cv.wait()
                deadline, token = self._heap[0]
                now = time.monotonic()
                if token not in self._live:
                    heapq.heappop(self._heap)
                    continue
                # memory poll: any live UDF with a cap forces a short wait
                capped = [(tok, rec) for tok, rec in self._live.items()
                          if rec[2] is not None]
                if capped:
                    rss = _rss_bytes()
                    for tok, (tid, base, cap) in capped:
                        if rss and rss - base > cap:
                            self._live.pop(tok, None)
                            kill = (tid, UdfMemoryExceeded)
                            break
                if kill is None and now < deadline:
                    wait = deadline - now
                    if capped:
                        wait = min(wait, self._MEM_POLL_S)
                    self._cv.wait(timeout=wait)
                    continue
                if kill is None:
                    heapq.heappop(self._heap)
                    rec = self._live.pop(token, None)
                    if rec is not None:
                        kill = (rec[0], UdfTimeout)
            if kill is not None:
                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(kill[0]), ctypes.py_object(kill[1]))


_watchdog = _Watchdog()


def run_limited(fn, args=(), kwargs=None, timeout_s: float = 3.0,
                mem_mb: float | None = None):
    """Run fn under the UDF watchdog: UdfTimeout raised in-thread on
    deadline expiry, UdfMemoryExceeded when process RSS grows more than
    mem_mb over the at-entry baseline while the UDF runs (the CPython
    analogue of the reference's JS_HEAP_SIZE limit, src/lib.rs:103 —
    approximate because RSS is process-wide, but it turns an allocation
    bomb into a clean per-call error instead of an OOM kill).
    timeout_s <= 0 disables both limits.  Both raises only interrupt
    Python bytecode; a single giant C-level allocation is not preemptible
    (documented limit)."""
    if timeout_s <= 0:
        return fn(*args, **(kwargs or {}))
    token = _watchdog.register(timeout_s, mem_mb)
    try:
        return fn(*args, **(kwargs or {}))
    except RecursionError:
        raise UdfError("UDF recursion limit exceeded")
    finally:
        _watchdog.cancel(token)


_SAFE_BUILTINS = {
    k: getattr(builtins, k)
    for k in (
        "abs", "all", "any", "bool", "dict", "enumerate", "filter", "float",
        "frozenset", "int", "len", "list", "map", "max", "min", "range",
        "repr", "reversed", "round", "set", "sorted", "str", "sum", "tuple",
        "zip", "isinstance", "ValueError", "TypeError", "Exception", "print",
    )
}


class _FalkorApi:
    """The `falkor` global visible to library code (udf/js_globals.rs)."""

    def __init__(self, lib: "UdfLibrary"):
        self._lib = lib

    def register(self, name: str, fn) -> None:
        if not callable(fn):
            raise UdfError(f"falkor.register({name!r}): not callable")
        self._lib.functions[name] = fn

    def log(self, *args) -> None:
        logger.info("[udf:%s] %s", self._lib.name,
                    " ".join(str(a) for a in args))


class UdfLibrary:
    def __init__(self, name: str, code: str):
        self.name = name
        self.code = code
        self.functions: dict[str, callable] = {}

    def load(self, timeout_s: float = 3.0) -> None:
        ns = {"__builtins__": _SAFE_BUILTINS, "math": math,
              "falkor": _FalkorApi(self)}
        try:
            run_limited(
                lambda: exec(compile(self.code, f"<udf:{self.name}>",
                                     "exec"), ns),
                timeout_s=timeout_s)
        except UdfError:
            raise
        except Exception as e:  # noqa: BLE001
            raise UdfError(f"error loading UDF library {self.name!r}: {e}")
        if not self.functions:
            raise UdfError(
                f"library {self.name!r} registered no functions")


class UdfRepository:
    def __init__(self, timeout_s: float = 3.0, mem_mb: float = 256.0):
        self.libs: dict[str, UdfLibrary] = {}
        self.version = 0
        self.timeout_s = timeout_s  # per-invocation wall budget
        self.mem_mb = mem_mb        # per-invocation RSS-growth budget
        self._lock = threading.Lock()

    def load(self, name: str, code: str, replace: bool = False) -> list[str]:
        with self._lock:
            if name in self.libs and not replace:
                raise UdfError(f"library {name!r} already exists")
            lib = UdfLibrary(name, code)
            lib.load(timeout_s=self.timeout_s)
            self.libs[name] = lib
            self.version += 1
            return sorted(lib.functions)

    def call(self, fn, args):
        """Invoke a UDF under the watchdog (js_context.rs interrupt role +
        heap-limit role)."""
        return run_limited(fn, args, timeout_s=self.timeout_s,
                           mem_mb=self.mem_mb)

    def delete(self, name: str) -> None:
        with self._lock:
            if name not in self.libs:
                raise UdfError(f"library {name!r} does not exist")
            del self.libs[name]
            self.version += 1

    def flush(self) -> None:
        with self._lock:
            self.libs.clear()
            self.version += 1

    def list(self, lib: str | None = None, with_code: bool = False):
        out = []
        for name, l in sorted(self.libs.items()):
            if lib is not None and name != lib:
                continue
            entry = {"library_name": name, "functions": sorted(l.functions)}
            if with_code:
                entry["library_code"] = l.code
            out.append(entry)
        return out

    def lookup(self, dotted: str):
        """`Lib.fn` → callable or None.  Case-sensitive on both parts
        (matching the reference's JS semantics)."""
        if "." not in dotted:
            return None
        lib, fn = dotted.split(".", 1)
        l = self.libs.get(lib)
        if l is None:
            return None
        return l.functions.get(fn)
