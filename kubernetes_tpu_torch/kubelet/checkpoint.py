"""Checkpoint manager: CRC-checksummed local state files.

Analog of `pkg/kubelet/checkpointmanager/checkpoint_manager.go` +
`checksum/checksum.go`: each checkpoint is JSON + a CRC of its payload;
corrupt files are detected and rejected on restore.
"""

from __future__ import annotations

import json
import os
import tempfile
import zlib
from typing import Any, Dict, List, Optional


class CorruptCheckpointError(Exception):
    pass


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        safe = key.replace("/", "_")
        return os.path.join(self.directory, f"{safe}.json")

    def create_checkpoint(self, key: str, data: Any) -> None:
        payload = json.dumps(data, sort_keys=True, separators=(",", ":"))
        doc = {"data": payload, "checksum": zlib.crc32(payload.encode())}
        # atomic write (tempfile + rename), as the reference's file store does
        fd, tmp = tempfile.mkstemp(dir=self.directory)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self._path(key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def get_checkpoint(self, key: str) -> Optional[Any]:
        try:
            with open(self._path(key)) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return None
        except json.JSONDecodeError as e:
            raise CorruptCheckpointError(str(e))
        payload = doc.get("data", "")
        if zlib.crc32(payload.encode()) != doc.get("checksum"):
            raise CorruptCheckpointError(f"checksum mismatch for {key}")
        return json.loads(payload)

    def remove_checkpoint(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def list_checkpoints(self) -> List[str]:
        return sorted(p[:-5] for p in os.listdir(self.directory)
                      if p.endswith(".json"))
