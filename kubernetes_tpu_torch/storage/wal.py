"""Write-ahead log + snapshot persistence for the MVCC kvstore (a copy of the
JAX package's storage/wal.py: the same bytes on disk, the same recovery
decision table; the port adds the fsync-seconds counter).

Role of etcd's `wal/` + `snap/` packages under the reference apiserver: every
mutation is framed, CRC'd and appended to a segment file BEFORE it is applied
to the in-memory store, so an apiserver process death loses nothing that was
acknowledged — bindings, Leases, bind intents and (critically) the revision
counter itself all come back on reboot. Both KV backends (native/kvstore.cpp
and PyKV) sit behind one `DurableKV` wrapper writing ONE wal format, so the
dlopen-fallback path produces byte-identical logs.

On-disk layout (`data_dir/`)::

    wal-00000001.log     append-only segment: 16-byte header
                         (magic "KTPUWAL1" + i64 seq) then frames
    snap-<rev 16d>.snap  compacted snapshot: magic "KTPUSNP1" + payload
                         + u32 crc32(payload); written tmp+rename (atomic)

    frame   := u32 len | u32 crc32(payload) | payload
    payload := u8 op | i64 rev | u32 klen | key | u32 vlen | value
    op      := 1 PUT | 2 DELETE | 3 COMPACT (rev = new floor, no key/value)

Durability policy (``KTPU_STORE_DURABILITY``):

    off     append only — no fsync ever (page cache still survives process
            death; only machine death can lose acknowledged writes)
    batch   group commit: a background flusher fsyncs every
            ``KTPU_WAL_FSYNC_INTERVAL`` seconds (default 0.05)
    always  fsync before every acknowledgement

Recovery decision table (`read_segment` / `load_state`):

    clean tail                      replay everything
    torn tail (short frame, or CRC  truncate the file at the bad frame and
    mismatch on the FINAL record    continue — the crash interrupted an
    of the FINAL segment)           unacknowledged append
    mid-log corruption (bad frame   refuse to start (WalCorruptionError):
    with valid bytes after it, or   history is rewritten, replaying past it
    in a non-final segment)         would reissue revisions
    corrupt snapshot                refuse to start (a partial snapshot can
                                    never carry the final name — tmp+rename)

The RV-continuity invariant: recovery seeds the revision counter from the
snapshot header and asserts every replayed record re-earns EXACTLY the
revision it logged. A reissued RV would silently corrupt every watch resume
token in the fleet, so a mismatch is a refuse-to-start corruption error.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import IO, Iterable, List, Optional, Tuple

from ..component.metrics import DEFAULT_REGISTRY as _REG, Counter
from ..utils import faultline

SEG_MAGIC = b"KTPUWAL1"
SNAP_MAGIC = b"KTPUSNP1"
SEG_HEADER_LEN = len(SEG_MAGIC) + 8

OP_PUT = 1
OP_DELETE = 2
OP_COMPACT = 3

_FRAME_HDR = struct.Struct("<II")   # len, crc32(payload)
_PAYLOAD_HDR = struct.Struct("<Bq")  # op, rev
_U32 = struct.Struct("<I")

WAL_APPENDS = _REG.counter(
    "apiserver_storage_wal_appends_total",
    "Records appended to the kvstore write-ahead log, by op "
    "(put, delete, compact)",
    labels=("op",))
WAL_FSYNCS = _REG.counter(
    "apiserver_storage_wal_fsyncs_total",
    "fsync calls issued by the WAL, by trigger (commit = the `always` "
    "policy's per-acknowledgement sync, batch = the group-commit flusher, "
    "rotate, snapshot, dir = directory-entry sync after create/rename)",
    labels=("trigger",))
# the port's own counter, kept off the shared registry: /metrics serves
# the series the metric catalogue (docs/OBSERVABILITY.md) names, and this
# one is read in process (chip_smoke.py's phase 14)
WAL_FSYNC_SECONDS = Counter(
    "apiserver_storage_wal_fsync_seconds_total",
    "Wall seconds spent in the WAL's fsync calls (file and directory), by "
    "trigger, as apiserver_storage_wal_fsyncs_total counts them",
    ("trigger",))
WAL_SNAPSHOTS = _REG.counter(
    "apiserver_storage_wal_snapshots_total",
    "Compacted snapshots written (each truncates the log: older segments "
    "and snapshots are deleted once the new snapshot is durable)")
RECOVERY_SECONDS = _REG.gauge(
    "apiserver_storage_recovery_seconds",
    "Wall seconds the last boot spent restoring the kvstore from disk "
    "(snapshot load + WAL tail replay)")
RECOVERY_RECORDS = _REG.gauge(
    "apiserver_storage_recovery_records",
    "Records restored by the last boot, by source (snapshot, wal); "
    "source=torn counts tail records discarded by the clean-truncate rule",
    labels=("source",))

_OP_NAMES = {OP_PUT: "put", OP_DELETE: "delete", OP_COMPACT: "compact"}


class WalError(Exception):
    """Base for WAL failures."""


class WalWriteError(WalError):
    """An append could not be made durable (disk full / IO error). The
    in-memory store was NOT mutated — the failed write simply never
    happened, exactly as if the request had been rejected."""


class WalCorruptionError(WalError):
    """Structured refuse-to-start error: the log or snapshot is damaged in
    a way replay cannot safely skip (mid-log corruption, snapshot CRC
    mismatch, or a replayed record that would re-earn a different revision
    than it logged)."""

    def __init__(self, reason: str, path: str = "", offset: int = -1):
        self.reason = reason
        self.path = path
        self.offset = offset
        where = f" at {os.path.basename(path)}" if path else ""
        where += f"+{offset}" if offset >= 0 else ""
        super().__init__(f"wal corruption{where}: {reason}")


@dataclass(frozen=True)
class WalRecord:
    op: int
    rev: int
    key: str
    value: bytes


@dataclass
class RecoveredState:
    """Everything `load_state` pulled off disk, ready to feed a backend."""

    snapshot_rev: int = 0
    snapshot_compacted: int = 0
    snapshot_records: List[Tuple[str, bytes, int, int]] = field(
        default_factory=list)  # (key, value, create_rev, mod_rev)
    wal_records: List[WalRecord] = field(default_factory=list)
    torn_tail_truncated: bool = False
    next_seq: int = 1


# --------------------------------------------------------------------- #
# framing
# --------------------------------------------------------------------- #

def encode_record(op: int, rev: int, key: str, value: bytes) -> bytes:
    kb = key.encode()
    return b"".join((
        _PAYLOAD_HDR.pack(op, rev),
        _U32.pack(len(kb)), kb,
        _U32.pack(len(value)), value,
    ))


def decode_record(payload: bytes) -> WalRecord:
    try:
        op, rev = _PAYLOAD_HDR.unpack_from(payload, 0)
        off = _PAYLOAD_HDR.size
        (klen,) = _U32.unpack_from(payload, off)
        off += 4
        key = payload[off:off + klen].decode()
        off += klen
        (vlen,) = _U32.unpack_from(payload, off)
        off += 4
        value = payload[off:off + vlen]
        if off + vlen != len(payload) or op not in _OP_NAMES:
            raise ValueError("trailing bytes or unknown op")
    except (struct.error, UnicodeDecodeError, ValueError) as e:
        raise WalCorruptionError(f"undecodable record payload: {e}") from None
    return WalRecord(op, rev, key, value)


def frame(payload: bytes) -> bytes:
    return _FRAME_HDR.pack(len(payload), zlib.crc32(payload)) + payload


# --------------------------------------------------------------------- #
# segment / snapshot files
# --------------------------------------------------------------------- #

def _fsync_dir(path: str) -> None:
    """Make directory entries durable. fsync on a file persists its bytes,
    not the name pointing at them: a rename/create is only crash-safe once
    the directory itself is synced."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds; nothing we can do
    try:
        t0 = time.perf_counter()
        os.fsync(fd)
        WAL_FSYNC_SECONDS.inc(time.perf_counter() - t0, trigger="dir")
        WAL_FSYNCS.inc(trigger="dir")
    finally:
        os.close(fd)


def _seg_name(seq: int) -> str:
    return f"wal-{seq:08d}.log"


def _snap_name(rev: int) -> str:
    return f"snap-{rev:016d}.snap"


def list_segments(data_dir: str) -> List[Tuple[int, str]]:
    out = []
    for n in os.listdir(data_dir):
        if n.startswith("wal-") and n.endswith(".log"):
            try:
                out.append((int(n[4:-4]), os.path.join(data_dir, n)))
            except ValueError:
                continue
    return sorted(out)


def list_snapshots(data_dir: str) -> List[Tuple[int, str]]:
    out = []
    for n in os.listdir(data_dir):
        if n.startswith("snap-") and n.endswith(".snap"):
            try:
                out.append((int(n[5:-5]), os.path.join(data_dir, n)))
            except ValueError:
                continue
    return sorted(out)


def read_segment(path: str, final: bool) -> Tuple[List[WalRecord],
                                                  Optional[int]]:
    """Parse one segment per the recovery decision table.

    Returns (records, truncate_at): truncate_at is the byte offset the
    caller must ftruncate the file to when the final record was torn
    (None = clean). Mid-log corruption raises WalCorruptionError."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < SEG_HEADER_LEN or data[:len(SEG_MAGIC)] != SEG_MAGIC:
        if final and len(data) < SEG_HEADER_LEN:
            # a crash between creating the file and writing its header —
            # nothing in it was ever acknowledged
            return [], 0
        raise WalCorruptionError("bad segment header", path=path, offset=0)
    records: List[WalRecord] = []
    off, size = SEG_HEADER_LEN, len(data)
    while off < size:
        def torn_or_corrupt(reason: str, tail: bool):
            # tail = the damage plausibly extends to EOF (an interrupted
            # append). Anything else — or any damage in a non-final
            # segment — is rewritten history: refuse.
            if final and tail:
                return None
            raise WalCorruptionError(reason, path=path, offset=off)

        if size - off < _FRAME_HDR.size:
            torn_or_corrupt("short frame header", tail=True)
            return records, off
        length, crc = _FRAME_HDR.unpack_from(data, off)
        end = off + _FRAME_HDR.size + length
        if end > size:
            torn_or_corrupt(f"frame of {length}B overruns segment",
                            tail=True)
            return records, off
        payload = data[off + _FRAME_HDR.size:end]
        if zlib.crc32(payload) != crc:
            torn_or_corrupt("payload CRC mismatch", tail=(end == size))
            return records, off
        records.append(decode_record(payload))
        off = end
    return records, None


def write_snapshot(data_dir: str, rev: int, compacted: int,
                   records: Iterable[Tuple[str, bytes, int, int]]) -> str:
    """Atomically persist the full keyspace at `rev` (tmp + rename: a
    partial snapshot can never carry the final name, so recovery either
    sees a complete CRC-valid file or none at all)."""
    parts = [struct.pack("<qq", rev, compacted)]
    n = 0
    for key, value, create_rev, mod_rev in records:
        kb = key.encode()
        parts.append(b"".join((
            _U32.pack(len(kb)), kb, _U32.pack(len(value)), value,
            struct.pack("<qq", create_rev, mod_rev))))
        n += 1
    parts.insert(0, struct.pack("<q", n))
    payload = b"".join(parts)
    path = os.path.join(data_dir, _snap_name(rev))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(SNAP_MAGIC + payload + _U32.pack(zlib.crc32(payload)))
        f.flush()
        t0 = time.perf_counter()
        os.fsync(f.fileno())
        WAL_FSYNC_SECONDS.inc(time.perf_counter() - t0, trigger="snapshot")
    os.replace(tmp, path)
    # the rename is only durable once the directory entry is — without this
    # a machine death could persist the caller's subsequent unlinks of the
    # old segments while losing the new snapshot: neither survives
    _fsync_dir(data_dir)
    WAL_FSYNCS.inc(trigger="snapshot")
    WAL_SNAPSHOTS.inc()
    return path


def read_snapshot(path: str) -> Tuple[int, int,
                                      List[Tuple[str, bytes, int, int]]]:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < len(SNAP_MAGIC) + 28 or data[:len(SNAP_MAGIC)] != SNAP_MAGIC:
        raise WalCorruptionError("bad snapshot header", path=path)
    payload, (crc,) = data[len(SNAP_MAGIC):-4], _U32.unpack(data[-4:])
    if zlib.crc32(payload) != crc:
        raise WalCorruptionError("snapshot CRC mismatch", path=path)
    try:
        n, rev, compacted = struct.unpack_from("<qqq", payload, 0)
        off = 24
        records = []
        for _ in range(n):
            (klen,) = _U32.unpack_from(payload, off)
            off += 4
            key = payload[off:off + klen].decode()
            off += klen
            (vlen,) = _U32.unpack_from(payload, off)
            off += 4
            value = payload[off:off + vlen]
            off += vlen
            create_rev, mod_rev = struct.unpack_from("<qq", payload, off)
            off += 16
            records.append((key, value, create_rev, mod_rev))
    except (struct.error, UnicodeDecodeError) as e:
        raise WalCorruptionError(f"undecodable snapshot: {e}",
                                 path=path) from None
    return rev, compacted, records


def load_state(data_dir: str) -> RecoveredState:
    """Read everything recoverable from `data_dir` (no backend touched).

    The `wal.torn@tail` chaos seam fires here: it chops bytes off the final
    segment before parsing, simulating the power cut landing mid-append."""
    st = RecoveredState()
    if not os.path.isdir(data_dir):
        return st
    segments = list_segments(data_dir)
    if segments and faultline.should("wal.torn", "tail"):
        _, last = segments[-1]
        sz = os.path.getsize(last)
        if sz > SEG_HEADER_LEN:
            with open(last, "r+b") as f:
                f.truncate(max(SEG_HEADER_LEN, sz - 7))
    snaps = list_snapshots(data_dir)
    if snaps:
        rev, compacted, records = read_snapshot(snaps[-1][1])
        st.snapshot_rev = rev
        # events at/below the snapshot revision are not persisted: the
        # recovered floor rises to the snapshot itself, so a resume beneath
        # it earns an HONEST 410 instead of a silent gap (etcd compaction
        # semantics); WAL-tail replay rebuilds the ring above it
        st.snapshot_compacted = max(compacted, rev)
        st.snapshot_records = records
    for i, (seq, path) in enumerate(segments):
        final = (i == len(segments) - 1)
        records, truncate_at = read_segment(path, final=final)
        if truncate_at is not None:
            # POSIX truncate EXTENDS a shorter file: a final segment that
            # died before its 16-byte header landed (truncate_at=0) must
            # shrink to empty so the writer rewrites a valid header — padding
            # it to SEG_HEADER_LEN zero bytes would make every subsequent
            # acknowledged append sit behind a corrupt header and brick the
            # NEXT boot
            with open(path, "r+b") as f:
                f.truncate(truncate_at if truncate_at >= SEG_HEADER_LEN
                           else 0)
            st.torn_tail_truncated = True
        st.wal_records.extend(records)
        st.next_seq = seq  # the writer re-opens the final segment for append
    return st


# --------------------------------------------------------------------- #
# writer
# --------------------------------------------------------------------- #

class WalWriter:
    """Append-only segment writer with the off/batch/always fsync policy.

    One writer per store; `append` is called under the DurableKV commit
    lock, so frames never interleave. The `batch` flusher thread group-
    commits via the synced-offset watermark — a sync that another sync
    already covered is skipped."""

    POLICIES = ("off", "batch", "always")

    def __init__(self, data_dir: str, durability: str = "batch",
                 fsync_interval: Optional[float] = None,
                 segment_bytes: Optional[int] = None,
                 start_seq: int = 1):
        if durability not in self.POLICIES:
            raise ValueError(
                f"KTPU_STORE_DURABILITY={durability!r}: want off|batch|always")
        self.data_dir = data_dir
        self.durability = durability
        self._fsync_interval = float(
            fsync_interval if fsync_interval is not None
            else os.environ.get("KTPU_WAL_FSYNC_INTERVAL", "0.05"))
        self._segment_bytes = int(
            segment_bytes if segment_bytes is not None
            else os.environ.get("KTPU_WAL_SEGMENT_BYTES", str(64 << 20)))
        os.makedirs(data_dir, exist_ok=True)
        self._mu = threading.Lock()
        self._f: Optional[IO[bytes]] = None
        self._seq = 0
        self._written = 0   # bytes appended to the current segment
        self._synced = 0    # bytes known durable (group-commit watermark)
        self._closed = False
        self._open_segment(start_seq)
        self._flusher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if durability == "batch":
            self._flusher = threading.Thread(
                target=self._flush_loop, name="wal-flusher", daemon=True)
            self._flusher.start()

    def _open_segment(self, seq: int) -> None:
        path = os.path.join(self.data_dir, _seg_name(seq))
        existed = os.path.exists(path)
        self._f = open(path, "ab")
        if not existed or os.path.getsize(path) < SEG_HEADER_LEN:
            # a partial header (crash between file creation and the 16th
            # byte) is wiped, never appended-after: the header must start
            # at offset 0
            self._f.truncate(0)
            self._f.write(SEG_MAGIC + struct.pack("<q", seq))
            self._f.flush()
            if not existed and self.durability != "off":
                # the file's bytes fsync with the first record; its
                # DIRECTORY ENTRY only becomes durable via the dir fd —
                # without this, machine death after a rotation can lose a
                # whole segment of acknowledged (file-fsynced) records
                _fsync_dir(self.data_dir)
        self._seq = seq
        self._written = self._f.tell()
        self._synced = 0

    def append(self, op: int, rev: int, key: str, value: bytes) -> None:
        """Make one record durable per the policy. Raises WalWriteError
        (nothing written) when the disk is full — the `disk.full@wal` seam
        fires here, BEFORE any bytes land, so the caller's memory state and
        the log can never disagree."""
        if faultline.should("disk.full", "wal"):
            raise WalWriteError("disk full (injected): wal append refused")
        buf = frame(encode_record(op, rev, key, value))
        with self._mu:
            f = self._f
            start = self._written
            try:
                f.write(buf)
                f.flush()
            except OSError as e:
                # a partial append must not survive as a "torn tail" the
                # next boot would silently truncate INTO acknowledged data
                try:
                    f.truncate(start)
                    f.seek(start)
                except OSError:
                    pass
                raise WalWriteError(f"wal append failed: {e}") from None
            self._written = start + len(buf)
            WAL_APPENDS.inc(op=_OP_NAMES.get(op, "?"))
            # record appended (page cache) but not yet fsynced
            faultline.crashpoint("wal:pre_fsync")
            if self.durability == "always":
                self._sync_locked(trigger="commit")
            # record durable (or policy says the flusher owns the sync);
            # the in-memory store has NOT yet applied it
            faultline.crashpoint("wal:post_fsync")
            if self._written >= self._segment_bytes:
                self._rotate_locked()

    def _sync_locked(self, trigger: str) -> None:
        if self._synced >= self._written or self._f is None:
            return  # group commit: someone already synced past us
        t0 = time.perf_counter()
        os.fsync(self._f.fileno())
        WAL_FSYNC_SECONDS.inc(time.perf_counter() - t0, trigger=trigger)
        self._synced = self._written
        WAL_FSYNCS.inc(trigger=trigger)

    def sync(self, trigger: str = "batch") -> None:
        with self._mu:
            if not self._closed:
                self._sync_locked(trigger=trigger)

    def _flush_loop(self) -> None:
        while not self._stop.wait(self._fsync_interval):
            try:
                self.sync(trigger="batch")
            except OSError:
                pass  # a failed background sync retries next tick

    def _rotate_locked(self) -> None:
        if self.durability != "off":
            self._sync_locked(trigger="rotate")
        self._f.close()
        self._open_segment(self._seq + 1)

    def snapshot(self, rev: int, compacted: int,
                 records: Iterable[Tuple[str, bytes, int, int]]) -> None:
        """Persist a snapshot and TRUNCATE the log: rotate to a fresh
        segment, then delete every older segment and snapshot — all their
        records are ≤ rev and covered by the new snapshot."""
        with self._mu:
            write_snapshot(self.data_dir, rev, compacted, records)
            self._rotate_locked()
            # snapshot rename + fresh segment creation must BOTH be durable
            # directory entries before any unlink below can land on disk
            _fsync_dir(self.data_dir)
            keep_seq, keep_snap = self._seq, rev
        for seq, path in list_segments(self.data_dir):
            if seq < keep_seq:
                try:
                    os.remove(path)
                except OSError:
                    pass
        for srev, path in list_snapshots(self.data_dir):
            if srev < keep_snap:
                try:
                    os.remove(path)
                except OSError:
                    pass

    def close(self) -> None:
        self._stop.set()
        if self._flusher is not None:
            self._flusher.join(timeout=2)
        with self._mu:
            if self._closed:
                return
            self._closed = True
            if self._f is not None:
                try:
                    if self.durability != "off":
                        self._sync_locked(trigger="commit")
                except OSError:
                    pass
                self._f.close()
                self._f = None
