"""The MVCC key-value store under the apiserver: a ctypes binding to the C++
store, its pure-Python replica, and the write-ahead-log wrapper (a copy of
the JAX package's storage/native.py).

The C++ store (csrc/kvstore.cpp, the port's own copy of the JAX package's
native/kvstore.cpp, which reads its event log from the asked revision
instead of from its start) plays the role etcd plays under the reference
apiserver (storage/etcd3/store.go). It is built at first use with the host compiler
into `build/kvstore/` in the checkout, named by a digest of source and
flags, so an edited source never loads a stale build. `PyKV` is a
pure-Python replica of the same interface for environments without a C++
toolchain; `new_kv` falls back to it visibly (the
`apiserver_storage_backend_info` gauge and one warning). `DurableKV` wraps
EITHER backend with the write-ahead log + snapshot layer (storage/wal.py) —
one wal format, the JAX package's byte for byte, so a data dir written by
either backend, or by either package, recovers into the other.
"""

from __future__ import annotations

import bisect
import ctypes
import fcntl
import hashlib
import logging
import os
import struct
import subprocess
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

from ..component.metrics import DEFAULT_REGISTRY as _REG
from ..utils import faultline

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KV_SOURCE = os.path.join(_PKG_DIR, "csrc", "kvstore.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kvstore")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
             "-pthread")

_log = logging.getLogger("ktpu.storage")

# which kvstore implementation actually carries the control plane — a fleet
# silently degraded to the slow pure-Python path by a toolchain break must be
# visible on a dashboard, not discovered by profiling
BACKEND_INFO = _REG.gauge(
    "apiserver_storage_backend_info",
    "1 for the kvstore backend this process selected (native = the C++ "
    "store, python = the PyKV fallback); the fallback series carries "
    'reason="build-failed|dlopen-failed|chaos|requested"',
    labels=("backend", "reason"))

EVENT_PUT = 0
EVENT_DELETE = 1
EVENT_CREATE = 2


class KVRecord(NamedTuple):
    key: str
    value: bytes
    create_rev: int
    mod_rev: int


class KVEvent(NamedTuple):
    rev: int
    type: int  # EVENT_PUT | EVENT_DELETE | EVENT_CREATE
    key: str
    value: bytes  # for DELETE: the previous value


class CompactedError(Exception):
    """Watch/list from a revision older than the compaction point."""


_build_error: Optional[str] = None  # why native is unavailable (surfaced
# once by new_kv's backend-visibility log line, never re-raised)


def library_path() -> str:
    """Where the C++ store's library for this source and these flags goes."""
    with open(KV_SOURCE, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libkvstore-{digest[:12]}.so")


def _build_lib(force: bool = False) -> Optional[str]:
    """Compile csrc/kvstore.cpp with the host compiler (CXX, else g++) unless
    the library for this source is there already. Safe under concurrent
    first uses, across processes too: one build at a time under a file lock
    in the build directory, the compiler writing a temporary name that is
    renamed into place. Returns the library's path, or None with the reason
    in `_build_error`."""
    global _build_error
    try:
        so = library_path()
        if os.path.exists(so) and not force:
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(so) and not force:
                return so  # another process built it while we waited
            tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
            cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                   KV_SOURCE]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=120)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        if os.path.exists(so):
            return so
        _build_error = "the compiler succeeded but produced no library"
        return None
    except subprocess.CalledProcessError as e:
        tail = (e.stderr or e.stdout or b"")[-300:]
        _build_error = f"build failed rc={e.returncode}: {tail!r}"
        return None
    except Exception as e:  # noqa: BLE001 - toolchain absence, timeout, ...
        _build_error = f"build unavailable: {e!r}"
        return None


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lib_lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        so = _build_lib()
        if not so:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            # a prebuilt .so linked against a NEWER libc than this host
            # (GLIBC_2.34-style version errors) raises at dlopen time, not
            # at build time: rebuild against the local toolchain once, and
            # if that fails too fall back to the pure-Python store instead
            # of poisoning every Store construction with an OSError
            so = _build_lib(force=True)
            if not so:
                return None
            try:
                lib = ctypes.CDLL(so)
            except OSError as e:
                global _build_error
                _build_error = f"dlopen failed after rebuild: {e}"
                return None
        lib.kv_new.restype = ctypes.c_void_p
        lib.kv_free.argtypes = [ctypes.c_void_p]
        for fn, args, res in [
            ("kv_rev", [ctypes.c_void_p], ctypes.c_int64),
            ("kv_compacted_rev", [ctypes.c_void_p], ctypes.c_int64),
            ("kv_put", [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                        ctypes.c_int64], ctypes.c_int64),
            ("kv_txn_put", [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                            ctypes.c_char_p, ctypes.c_int64], ctypes.c_int64),
            ("kv_txn_delete", [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_int64], ctypes.c_int64),
            ("kv_get", [ctypes.c_void_p, ctypes.c_char_p,
                        ctypes.POINTER(ctypes.c_char_p),
                        ctypes.POINTER(ctypes.c_int64),
                        ctypes.POINTER(ctypes.c_int64),
                        ctypes.POINTER(ctypes.c_int64)], ctypes.c_int64),
            ("kv_range", [ctypes.c_void_p, ctypes.c_char_p,
                          ctypes.POINTER(ctypes.c_char_p),
                          ctypes.POINTER(ctypes.c_int64),
                          ctypes.POINTER(ctypes.c_int64)], ctypes.c_int64),
            ("kv_count", [ctypes.c_void_p, ctypes.c_char_p], ctypes.c_int64),
            ("kv_events_since", [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.POINTER(ctypes.c_int64)], ctypes.c_int64),
            ("kv_wait", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64],
             ctypes.c_int64),
            ("kv_compact", [ctypes.c_void_p, ctypes.c_int64], ctypes.c_int64),
            ("kv_load", [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                         ctypes.c_int64, ctypes.c_int64, ctypes.c_int64],
             None),
            ("kv_init", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64],
             None),
            ("kv_buf_free", [ctypes.c_char_p], None),
        ]:
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = res
        _lib = lib
        return _lib


def _parse_records(buf: bytes) -> List[Tuple[int, int, str, bytes]]:
    """Decode [i64 a][i64 b][i64 klen][key][i64 vlen][val]* records."""
    out = []
    off, n = 0, len(buf)
    while off < n:
        a, b, klen = struct.unpack_from("<qqq", buf, off)
        off += 24
        key = buf[off:off + klen].decode()
        off += klen
        (vlen,) = struct.unpack_from("<q", buf, off)
        off += 8
        val = buf[off:off + vlen]
        off += vlen
        out.append((a, b, key, val))
    return out


class NativeKV:
    """The C++ store. All revisions are int; value payloads are bytes."""

    def __init__(self) -> None:
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native kvstore unavailable")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.kv_new())

    def close(self) -> None:
        # Deliberately do NOT kv_free: daemon threads (informer reflectors,
        # watch pumps) may still be inside a C call on this handle; freeing
        # under them is a use-after-free. One store lives per process in
        # production; tests leak a few KB per store instead of segfaulting.
        self._h_closed = True

    def rev(self) -> int:
        return int(self._lib.kv_rev(self._h))

    def compacted_rev(self) -> int:
        return int(self._lib.kv_compacted_rev(self._h))

    def put(self, key: str, value: bytes) -> int:
        return int(self._lib.kv_put(self._h, key.encode(), value, len(value)))

    def txn_put(self, key: str, expected_mod_rev: int, value: bytes) -> int:
        """expected 0=create-only, >0=CAS on mod_rev, -1=unconditional.
        Returns new rev or -1 on condition failure."""
        return int(self._lib.kv_txn_put(self._h, key.encode(),
                                        expected_mod_rev, value, len(value)))

    def txn_delete(self, key: str, expected_mod_rev: int = -1) -> int:
        """Returns new rev, 0 if absent, -1 on condition failure."""
        return int(self._lib.kv_txn_delete(self._h, key.encode(),
                                           expected_mod_rev))

    def get(self, key: str) -> Optional[KVRecord]:
        out = ctypes.c_char_p()
        out_len = ctypes.c_int64()
        crev = ctypes.c_int64()
        mrev = ctypes.c_int64()
        found = self._lib.kv_get(self._h, key.encode(), ctypes.byref(out),
                                 ctypes.byref(out_len), ctypes.byref(crev),
                                 ctypes.byref(mrev))
        if not found:
            return None
        try:
            val = ctypes.string_at(out, out_len.value)
        finally:
            self._lib.kv_buf_free(out)
        return KVRecord(key, val, crev.value, mrev.value)

    def range(self, prefix: str) -> Tuple[List[KVRecord], int]:
        out = ctypes.c_char_p()
        out_len = ctypes.c_int64()
        at_rev = ctypes.c_int64()
        self._lib.kv_range(self._h, prefix.encode(), ctypes.byref(out),
                           ctypes.byref(out_len), ctypes.byref(at_rev))
        try:
            buf = ctypes.string_at(out, out_len.value)
        finally:
            self._lib.kv_buf_free(out)
        recs = [KVRecord(k, v, a, b) for a, b, k, v in _parse_records(buf)]
        return recs, at_rev.value

    def count(self, prefix: str) -> int:
        return int(self._lib.kv_count(self._h, prefix.encode()))

    def events_since(self, since_rev: int, prefix: str = "") -> List[KVEvent]:
        out = ctypes.c_char_p()
        out_len = ctypes.c_int64()
        n = self._lib.kv_events_since(self._h, since_rev, prefix.encode(),
                                      ctypes.byref(out), ctypes.byref(out_len))
        if n < 0:
            raise CompactedError(f"revision {since_rev} already compacted")
        try:
            buf = ctypes.string_at(out, out_len.value)
        finally:
            self._lib.kv_buf_free(out)
        return [KVEvent(rev, typ, k, v) for rev, typ, k, v in _parse_records(buf)]

    def wait(self, rev: int, timeout: float) -> int:
        return int(self._lib.kv_wait(self._h, rev, int(timeout * 1000)))

    def compact(self, at_rev: int) -> int:
        return int(self._lib.kv_compact(self._h, at_rev))

    def load(self, key: str, value: bytes, create_rev: int,
             mod_rev: int) -> None:
        """Snapshot restore: install a record without a rev bump or event."""
        self._lib.kv_load(self._h, key.encode(), value, len(value),
                          create_rev, mod_rev)

    def init_rev(self, rev: int, compacted_rev: int) -> None:
        """Seed rev counter + compaction floor from durable state (recovery
        only — calling this on a live store corrupts MVCC history)."""
        self._lib.kv_init(self._h, rev, compacted_rev)


class PyKV:
    """The in-memory MVCC store: one revision counter, each record with its
    create and last-modify revisions, and the event log the watch hub reads
    (the JAX package's storage/native.py PyKV, with the native store's
    costs: a range is O(log n + k) over a sorted key index, not a sort of
    every key, and a read of the log starts at its revision — the
    apiserver's admission chain ranges on every create, and the watch pump
    reads the log on every write)."""

    MAX_EVENTS = 1 << 20  # bound the log for the process lifetime even
    # when nothing calls compact()

    def __init__(self) -> None:
        self._mu = threading.Condition()
        self._data: dict = {}  # key -> (value, create_rev, mod_rev)
        self._keys: List[str] = []  # the keys of _data, sorted
        self._events: List[KVEvent] = []
        self._rev = 0
        self._compacted = 0

    def _trim_locked(self) -> None:
        if len(self._events) > self.MAX_EVENTS:
            drop = len(self._events) - self.MAX_EVENTS
            self._compacted = self._events[drop - 1].rev
            del self._events[:drop]

    def close(self) -> None:
        pass

    def rev(self) -> int:
        with self._mu:
            return self._rev

    def compacted_rev(self) -> int:
        with self._mu:
            return self._compacted

    def put(self, key: str, value: bytes) -> int:
        return self.txn_put(key, -1, value)

    def txn_put(self, key: str, expected_mod_rev: int, value: bytes) -> int:
        """Write `value` if the record's mod revision is `expected_mod_rev`
        (0: the key must not exist; -1: unconditional). Returns the new
        revision, or -1 when the condition fails."""
        with self._mu:
            cur = self._data.get(key)
            if expected_mod_rev == 0 and cur is not None:
                return -1
            if expected_mod_rev > 0 and (cur is None
                                         or cur[2] != expected_mod_rev):
                return -1
            self._rev += 1
            create = cur[1] if cur else self._rev
            if cur is None:
                bisect.insort(self._keys, key)
            self._data[key] = (value, create, self._rev)
            self._events.append(KVEvent(
                self._rev, EVENT_PUT if cur else EVENT_CREATE, key, value))
            self._trim_locked()
            self._mu.notify_all()
            return self._rev

    def txn_delete(self, key: str, expected_mod_rev: int = -1) -> int:
        """Delete if the record's mod revision is `expected_mod_rev` (-1:
        unconditional). Returns the new revision, 0 when absent, -1 when the
        condition fails."""
        with self._mu:
            cur = self._data.get(key)
            if cur is None:
                return 0
            if expected_mod_rev > 0 and cur[2] != expected_mod_rev:
                return -1
            self._rev += 1
            del self._data[key]
            del self._keys[bisect.bisect_left(self._keys, key)]
            self._events.append(KVEvent(self._rev, EVENT_DELETE, key, cur[0]))
            self._trim_locked()
            self._mu.notify_all()
            return self._rev

    def get(self, key: str) -> Optional[KVRecord]:
        with self._mu:
            cur = self._data.get(key)
            return None if cur is None else KVRecord(key, *cur)

    def _prefixed(self, prefix: str) -> List[str]:
        """The keys under `prefix`, in key order (caller holds _mu)."""
        lo = bisect.bisect_left(self._keys, prefix)
        hi = bisect.bisect_left(self._keys, prefix + "\U0010ffff") \
            if prefix else len(self._keys)
        return self._keys[lo:hi]

    def range(self, prefix: str) -> Tuple[List[KVRecord], int]:
        """Every record under `prefix`, sorted by key (both JAX backends'
        order), and the store revision of the read."""
        with self._mu:
            recs = [KVRecord(k, *self._data[k]) for k in self._prefixed(prefix)]
            return recs, self._rev

    def count(self, prefix: str) -> int:
        with self._mu:
            return len(self._prefixed(prefix))

    def events_since(self, since_rev: int, prefix: str = "") -> List[KVEvent]:
        with self._mu:
            if since_rev < self._compacted:
                raise CompactedError(f"revision {since_rev} already compacted")
            # one event per revision, in order: the log from since_rev + 1
            # starts at a known offset
            start = 0
            if self._events:
                start = min(max(0, since_rev + 1 - self._events[0].rev),
                            len(self._events))
            return [e for e in self._events[start:]
                    if e.rev > since_rev and e.key.startswith(prefix)]

    def wait(self, rev: int, timeout: float) -> int:
        with self._mu:
            self._mu.wait_for(lambda: self._rev > rev, timeout=timeout)
            return self._rev

    def compact(self, at_rev: int) -> int:
        with self._mu:
            self._events = [e for e in self._events if e.rev > at_rev]
            if at_rev > self._compacted:
                self._compacted = at_rev
            return self._compacted


    def load(self, key: str, value: bytes, create_rev: int,
             mod_rev: int) -> None:
        """Snapshot restore: install a record without a rev bump or event."""
        with self._mu:
            if key not in self._data:
                bisect.insort(self._keys, key)
            self._data[key] = (value, create_rev, mod_rev)

    def init_rev(self, rev: int, compacted_rev: int) -> None:
        """Seed rev counter + compaction floor from durable state (recovery
        only — calling this on a live store corrupts MVCC history)."""
        with self._mu:
            self._rev = rev
            self._compacted = compacted_rev


class DurableKV:
    """WAL-before-apply wrapper giving either backend crash consistency.

    Every mutation serializes through one commit lock: predict the revision
    the backend will assign (`rev()+1`), pre-check the CAS condition, make
    the record durable (storage/wal.py, per the fsync policy), THEN apply to
    the in-memory backend and assert it earned exactly the predicted
    revision. An acknowledged write is therefore always on disk before it is
    visible — a crash between append and apply re-delivers it on recovery
    (the etcd contract: committed-but-unacked writes may surface after
    reboot; lost acknowledged writes may not).

    Reads delegate straight to the backend (its own lock suffices);
    `events_since`/`wait` keep working unchanged, so the Storage watch pump
    is oblivious to durability.
    """

    def __init__(self, backend, data_dir: str,
                 durability: Optional[str] = None,
                 snapshot_every: Optional[int] = None,
                 segment_bytes: Optional[int] = None):
        from . import wal as _wal

        self._wal_mod = _wal
        self._backend = backend
        self.data_dir = data_dir
        self.durability = (
            durability if durability is not None
            else os.environ.get("KTPU_STORE_DURABILITY", "batch"))
        self._snapshot_every = int(
            snapshot_every if snapshot_every is not None
            else os.environ.get("KTPU_WAL_SNAPSHOT_EVERY", "100000"))
        self._mu = threading.RLock()
        t0 = time.perf_counter()
        st = _wal.load_state(data_dir)
        self._recover(st)
        self._wal = _wal.WalWriter(
            data_dir, durability=self.durability,
            segment_bytes=segment_bytes,
            start_seq=max(1, st.next_seq))
        self._since_snapshot = len(st.wal_records)
        self.recovered = (bool(st.snapshot_records) or bool(st.wal_records)
                          or st.snapshot_rev > 0)
        self.torn_tail_truncated = st.torn_tail_truncated
        self.recovery_seconds = time.perf_counter() - t0
        _wal.RECOVERY_SECONDS.set(self.recovery_seconds)
        _wal.RECOVERY_RECORDS.set(len(st.snapshot_records),
                                  source="snapshot")
        _wal.RECOVERY_RECORDS.set(len(st.wal_records), source="wal")
        _wal.RECOVERY_RECORDS.set(1 if st.torn_tail_truncated else 0,
                                  source="torn")
        if self.recovered:
            _log.info(
                "kvstore recovered from %s: snapshot rev=%d (%d records) "
                "+ %d wal records -> rev=%d floor=%d torn_tail=%s in %.3fs",
                data_dir, st.snapshot_rev, len(st.snapshot_records),
                len(st.wal_records), self._backend.rev(),
                self._backend.compacted_rev(), st.torn_tail_truncated,
                self.recovery_seconds)

    def _recover(self, st) -> None:
        wal = self._wal_mod
        b = self._backend
        for key, value, create_rev, mod_rev in st.snapshot_records:
            b.load(key, value, create_rev, mod_rev)
        b.init_rev(st.snapshot_rev, st.snapshot_compacted)
        for rec in st.wal_records:
            if rec.op == wal.OP_COMPACT:
                if rec.rev > b.compacted_rev():
                    b.compact(rec.rev)
                continue
            if rec.rev <= st.snapshot_rev:
                continue  # already inside the snapshot
            if rec.op == wal.OP_PUT:
                got = b.put(rec.key, rec.value)
            else:
                got = b.txn_delete(rec.key, -1)
            if got != rec.rev:
                # RV continuity: the replayed mutation MUST re-earn exactly
                # the revision it logged; anything else means history is
                # rewritten and every resume token in the fleet is a lie
                raise wal.WalCorruptionError(
                    f"replay discontinuity: logged rev {rec.rev} for "
                    f"{wal._OP_NAMES[rec.op]} {rec.key!r} but backend "
                    f"assigned {got}")

    # -- mutations: WAL-before-apply ------------------------------------ #

    def put(self, key: str, value: bytes) -> int:
        return self.txn_put(key, -1, value)

    def txn_put(self, key: str, expected_mod_rev: int, value: bytes) -> int:
        wal = self._wal_mod
        b = self._backend
        with self._mu:
            cur = b.get(key)
            if expected_mod_rev == 0 and cur is not None:
                return -1
            if expected_mod_rev > 0 and (cur is None
                                         or cur.mod_rev != expected_mod_rev):
                return -1
            rev = b.rev() + 1
            self._wal.append(wal.OP_PUT, rev, key, value)
            got = b.txn_put(key, expected_mod_rev, value)
            if got != rev:
                # not an assert: this invariant must hold under python -O
                # too — a skew means the WAL logged one revision while the
                # backend assigned another, corrupting replay and every
                # resume token in the fleet
                raise wal.WalCorruptionError(
                    f"wal/backend rev skew on put {key!r}: "
                    f"logged {rev}, backend assigned {got}")
            # the record is durable AND applied — the site a mid-commit
            # apiserver kill exercises in the cold-restart drill
            faultline.crashpoint("wal:post_append")
            self._maybe_snapshot_locked()
            return rev

    def txn_delete(self, key: str, expected_mod_rev: int = -1) -> int:
        wal = self._wal_mod
        b = self._backend
        with self._mu:
            cur = b.get(key)
            if cur is None:
                return 0
            if expected_mod_rev > 0 and cur.mod_rev != expected_mod_rev:
                return -1
            rev = b.rev() + 1
            self._wal.append(wal.OP_DELETE, rev, key, b"")
            got = b.txn_delete(key, expected_mod_rev)
            if got != rev:
                raise wal.WalCorruptionError(
                    f"wal/backend rev skew on delete {key!r}: "
                    f"logged {rev}, backend assigned {got}")
            faultline.crashpoint("wal:post_append")
            self._maybe_snapshot_locked()
            return rev

    def compact(self, at_rev: int) -> int:
        wal = self._wal_mod
        with self._mu:
            self._wal.append(wal.OP_COMPACT, at_rev, "", b"")
            return self._backend.compact(at_rev)

    def _maybe_snapshot_locked(self) -> None:
        self._since_snapshot += 1
        if self._since_snapshot >= self._snapshot_every:
            self.snapshot()

    def snapshot(self) -> None:
        """Write a full-keyspace snapshot and truncate the log."""
        with self._mu:
            b = self._backend
            recs, at_rev = b.range("")
            self._wal.snapshot(
                at_rev, b.compacted_rev(),
                ((r.key, r.value, r.create_rev, r.mod_rev) for r in recs))
            self._since_snapshot = 0

    # -- reads / plumbing: straight delegation -------------------------- #

    def close(self) -> None:
        self._wal.close()
        self._backend.close()

    def rev(self) -> int:
        return self._backend.rev()

    def compacted_rev(self) -> int:
        return self._backend.compacted_rev()

    def get(self, key: str) -> Optional[KVRecord]:
        return self._backend.get(key)

    def range(self, prefix: str) -> Tuple[List[KVRecord], int]:
        return self._backend.range(prefix)

    def count(self, prefix: str) -> int:
        return self._backend.count(prefix)

    def events_since(self, since_rev: int, prefix: str = "") -> List[KVEvent]:
        return self._backend.events_since(since_rev, prefix)

    def wait(self, rev: int, timeout: float) -> int:
        return self._backend.wait(rev, timeout)


_backend_reported = False


def _report_backend(backend: str, reason: str) -> None:
    """Once per process: which kvstore carries the control plane, and why.
    A toolchain break must not silently demote a fleet to the slow path."""
    global _backend_reported
    if _backend_reported:
        return
    _backend_reported = True
    BACKEND_INFO.set(1, backend=backend, reason=reason)
    if backend == "python":
        _log.warning(
            "kvstore backend: python (PyKV fallback, reason=%s%s) — the "
            "native C++ store is NOT serving this process",
            reason, f"; build error: {_build_error}" if _build_error else "")
    else:
        _log.info("kvstore backend: native (%s)", library_path())


def new_kv(prefer_native: bool = True, data_dir: Optional[str] = None,
           durability: Optional[str] = None):
    """Factory: native store if buildable, else the Python replica; either
    is wrapped in the WAL/recovery layer when `data_dir` is given."""
    backend = None
    if faultline.should("native.dlopen", "new_kv"):
        # chaos: the .so linked against a newer libc than this host —
        # dlopen fails, the PyKV fallback must carry the store
        backend = PyKV()
        _report_backend("python", "chaos")
    elif prefer_native:
        try:
            backend = NativeKV()
            _report_backend("native", "preferred")
        except RuntimeError:
            pass
    if backend is None:
        backend = PyKV()
        _report_backend(
            "python",
            ("build-failed" if prefer_native else "requested"))
    if data_dir:
        return DurableKV(backend, data_dir, durability=durability)
    return backend
