"""Append-only write log (the reference's AOF role: effects buffers are
streamed to Redis' AOF via replicate-verbatim / effects, pending.rs:1629,
src/graph_core.rs:1465-1505).

Crash recovery = checkpoint + log replay: every committed write appends one
record — either the binary effects buffer (kind=EFFECTS) or the verbatim
query text+params (kind=QUERY, chosen by GraphCore._should_use_effects).
`FalkorDB.save` checkpoints and then truncates the log, so recovery replays
only the suffix since the last checkpoint.

Durability format (v2): the file opens with [u32 MAGIC][u16 VERSION]; each
record is [u32 payload_len][u8 kind][u32 crc32(kind+payload)][payload].
QUERY payloads use the tag-prefixed value codec from persist/effects.py
(never pickle — a durability format must not be tied to Python pickling,
matching the reference's versioned serializers discipline,
/root/reference/src/serializers/).  Readers verify the CRC per record and
stop at the first corrupt/torn record; legacy v1 logs (no header, no CRC,
pickled QUERY payloads) upgrade once via `EffectsLog.migrate_v1` — v1
QUERY records are never silently dropped, and replay of an unmigrated v1
log raises with instructions."""

from __future__ import annotations

import os
import struct
import threading
import zlib

from falkordb_tpu_torch.persist.effects import _dec_value, _enc_value

K_EFFECTS = 1
K_QUERY = 2

AOF_MAGIC = 0x464C4F47  # 'GOLF'
AOF_VERSION = 2
_HEADER = struct.pack("<IH", AOF_MAGIC, AOF_VERSION)


def _encode_query(text: str, params) -> bytes:
    out = bytearray()
    tb = text.encode()
    out.extend(struct.pack("<I", len(tb)))
    out.extend(tb)
    _enc_value(out, dict(params) if params else {})
    return bytes(out)


def _decode_query(payload: bytes):
    buf = memoryview(payload)
    (n,) = struct.unpack_from("<I", buf, 0)
    text = bytes(buf[4: 4 + n]).decode()
    params, _ = _dec_value(buf, 4 + n)
    return text, params


def _safe_unpickle_query(payload: bytes):
    """Decode a v1 pickled (text, params) QUERY payload with a restricted
    unpickler: plain data pickles never call find_class, so any global
    lookup means the payload is not a legitimate v1 record."""
    import io
    import pickle

    class _SafeUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            raise pickle.UnpicklingError(
                f"v1 AOF migration forbids global {module}.{name}")

    text, params = _SafeUnpickler(io.BytesIO(payload)).load()
    if not isinstance(text, str):
        raise ValueError("v1 QUERY record: text is not a string")
    return text, params


class EffectsLog:
    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        self._f = open(path, "ab")
        if fresh:
            self._f.write(_HEADER)
            self._f.flush()

    def _append(self, kind: int, payload: bytes) -> None:
        crc = zlib.crc32(bytes([kind]) + payload) & 0xFFFFFFFF
        rec = struct.pack("<IBI", len(payload), kind, crc) + payload
        with self._lock:
            self._f.write(rec)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())

    def append_effects(self, blob: bytes) -> None:
        self._append(K_EFFECTS, blob)

    def append_query(self, text: str, params) -> None:
        self._append(K_QUERY, _encode_query(text, params))

    def reset(self) -> None:
        """Truncate after a checkpoint: the log now only needs to cover
        writes since that snapshot."""
        with self._lock:
            self._f.close()
            self._f = open(self.path, "wb")
            self._f.write(_HEADER)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()

    @staticmethod
    def records(path: str, allow_v1_pickle: bool = False):
        """Iterate (kind, payload) records; verifies per-record CRC and
        tolerates a torn final record (partial write at crash) by stopping
        at the first record that is short or fails its checksum.

        Legacy v1 logs (round-2 format: no header/CRC, QUERY payloads
        pickled): EFFECTS records always replay; QUERY records raise
        unless `allow_v1_pickle=True`, in which case they are decoded with
        a restricted unpickler (plain data only) and yielded re-encoded in
        the v2 codec — the one-time migration path (see `migrate_v1`).
        Matching the reference's versioned-decoder discipline
        (/root/reference/src/serializers/mod.rs:22)."""
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        if len(data) >= 6 and struct.unpack_from("<IH", data, 0)[0] == AOF_MAGIC:
            version = struct.unpack_from("<IH", data, 0)[1]
            if version > AOF_VERSION:
                raise ValueError(f"AOF version {version} is newer than "
                                 f"supported {AOF_VERSION}")
            off = 6
            while off + 9 <= len(data):
                ln, kind, crc = struct.unpack_from("<IBI", data, off)
                end = off + 9 + ln
                if end > len(data):
                    break  # torn tail record — drop it
                payload = data[off + 9: end]
                if zlib.crc32(bytes([kind]) + payload) & 0xFFFFFFFF != crc:
                    break  # corrupt record — treat as torn tail
                yield kind, payload
                off = end
            return
        # legacy v1: [u32 len][u8 kind][payload], QUERY payloads pickled
        off = 0
        while off + 5 <= len(data):
            (ln, kind) = struct.unpack_from("<IB", data, off)
            if off + 5 + ln > len(data):
                break
            payload = data[off + 5: off + 5 + ln]
            if kind == K_EFFECTS:
                yield kind, payload
            elif kind == K_QUERY:
                if not allow_v1_pickle:
                    raise ValueError(
                        "v1 AOF contains pickled QUERY records; run "
                        "EffectsLog.migrate_v1(path) once to upgrade the "
                        "log to the v2 codec")
                text, params = _safe_unpickle_query(payload)
                yield kind, _encode_query(text, params)
            off += 5 + ln

    @staticmethod
    def migrate_v1(path: str) -> int:
        """One-time in-place upgrade of a v1 log to the v2 format (CRC'd
        records, codec-encoded queries).  v1 pickled QUERY payloads are
        decoded with a restricted unpickler that admits plain data only.
        Returns the migrated record count; atomic (tmp file + rename)."""
        tmp = path + ".migrate"
        n = 0
        with open(tmp, "wb") as f:
            f.write(_HEADER)
            for kind, payload in EffectsLog.records(
                    path, allow_v1_pickle=True):
                crc = zlib.crc32(bytes([kind]) + payload) & 0xFFFFFFFF
                f.write(struct.pack("<IBI", len(payload), kind, crc)
                        + payload)
                n += 1
        os.replace(tmp, path)
        return n

    @staticmethod
    def replay(path: str, core) -> int:
        """Apply every record to `core`; returns the replay count."""
        n = 0
        for kind, payload in EffectsLog.records(path):
            if kind == K_EFFECTS:
                core.apply_effects_blob(payload)
            else:
                text, params = _decode_query(payload)
                core.query(text, params=params)
            n += 1
        return n
