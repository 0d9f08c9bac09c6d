"""Persistence layer: the MVCC kvstore + storage.Interface (a copy of the
JAX package's storage/).

Analog of SURVEY.md layer 1 (etcd + the apiserver's etcd3 storage,
staging/src/k8s.io/apiserver/pkg/storage/etcd3/). The store itself is C++
(csrc/kvstore.cpp, built at first use) behind a ctypes binding, with a
pure-Python fallback; storage/wal.py makes either durable.
"""

from .native import CompactedError, DurableKV, NativeKV, PyKV, new_kv
from .store import Storage
from .wal import WalCorruptionError, WalWriteError

__all__ = ["CompactedError", "DurableKV", "NativeKV", "PyKV", "new_kv",
           "Storage", "WalCorruptionError", "WalWriteError"]
