"""Versioned object storage over an in-memory MVCC key-value store — the
subset of the JAX package's storage (storage/native.py `PyKV`,
storage/store.py `Storage`) that the bind-intent ledger (sched/ledger.py)
needs: CAS create, get, prefix list and CAS delete.

Analog of `staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go`: objects
are JSON-encoded under their key; as in the reference, resourceVersion is
NOT stored in the value — it is filled from the record's mod_revision on
every read (store.go Versioner). The watch hub, the watch cache, the WAL and
the native C++ backend belong to the apiserver, which the port does not
reach yet (ROADMAP A11b); the ledger takes any storage with these four calls,
so it also runs over the JAX package's `Storage` and its WAL-backed store.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from ..machinery import errors, meta

Obj = Dict[str, Any]


class KVRecord(NamedTuple):
    key: str
    value: bytes
    create_rev: int
    mod_rev: int


class PyKV:
    """The in-memory MVCC store: one revision counter, each record with its
    create and last-modify revisions (the JAX package's PyKV, less the event
    log its watch hub reads)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._data: Dict[str, Tuple[bytes, int, int]] = {}
        self._rev = 0

    def close(self) -> None:
        pass

    def rev(self) -> int:
        with self._mu:
            return self._rev

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
            self._data[key] = (value, create, self._rev)
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
            return self._rev

    def get(self, key: str) -> Optional[KVRecord]:
        with self._mu:
            cur = self._data.get(key)
            return None if cur is None else KVRecord(key, *cur)

    def range(self, prefix: str) -> Tuple[List[KVRecord], int]:
        with self._mu:
            recs = [KVRecord(k, *v) for k, v in sorted(self._data.items())
                    if k.startswith(prefix)]
            return recs, self._rev


def _encode(obj: Obj) -> bytes:
    obj = dict(obj)
    md = dict(obj.get("metadata") or {})
    md.pop("resourceVersion", None)
    obj["metadata"] = md
    return json.dumps(obj, separators=(",", ":"), sort_keys=True).encode()


def _decode(data: bytes, rev: int) -> Obj:
    obj = json.loads(data)
    meta.set_resource_version(obj, str(rev))
    return obj


class Storage:
    """Object store over one KV backend (etcd3 store.go Create:143 / Get:86
    / List / Delete)."""

    def __init__(self, kv=None) -> None:
        self.kv = kv if kv is not None else PyKV()

    def close(self) -> None:
        self.kv.close()

    def create(self, key: str, obj: Obj, resource: str = "object") -> Obj:
        rev = self.kv.txn_put(key, 0, _encode(obj))
        if rev < 0:
            raise errors.new_already_exists(resource, meta.name(obj))
        out = meta.deep_copy(obj)
        meta.set_resource_version(out, str(rev))
        return out

    def get(self, key: str, resource: str = "object", name: str = "") -> Obj:
        rec = self.kv.get(key)
        if rec is None:
            raise errors.new_not_found(resource, name or key)
        return _decode(rec.value, rec.mod_rev)

    def list(self, prefix: str) -> Tuple[List[Obj], str]:
        recs, at_rev = self.kv.range(prefix)
        return [_decode(r.value, r.mod_rev) for r in recs], str(at_rev)

    def delete(self, key: str, resource: str = "object", name: str = "",
               expected_rv: Optional[str] = None) -> Obj:
        while True:
            rec = self.kv.get(key)
            if rec is None:
                raise errors.new_not_found(resource, name or key)
            if expected_rv is not None and str(rec.mod_rev) != expected_rv:
                raise errors.new_conflict(resource, name or key,
                                          "the object has been modified")
            rv = self.kv.txn_delete(key, rec.mod_rev)
            if rv > 0:
                return _decode(rec.value, rec.mod_rev)
            if rv == 0:
                raise errors.new_not_found(resource, name or key)
            # lost a race with a concurrent update; retry
