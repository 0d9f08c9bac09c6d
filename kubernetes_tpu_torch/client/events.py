"""Event recording.

Analog of client-go `tools/record`: EventRecorder.Eventf producing v1 Events
with series counting (repeated events aggregate into count bumps, the
EventCorrelator's role).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ..machinery import errors, meta


class EventRecorder:
    def __init__(self, client, component: str = "kubernetes-tpu"):
        self.client = client
        self.component = component
        self._mu = threading.Lock()
        # (ns, involved-uid, reason, message) -> event name
        self._seen: Dict[Tuple[str, str, str, str], str] = {}

    def event(self, involved: dict, event_type: str, reason: str,
              message: str) -> Optional[dict]:
        """record.Eventf. event_type ∈ {Normal, Warning}."""
        ns = meta.namespace(involved) or "default"
        dedup = (ns, meta.uid(involved) or meta.name(involved), reason, message)
        with self._mu:
            existing_name = self._seen.get(dedup)
        try:
            if existing_name:
                bumped = self._bump(existing_name, ns)
                if bumped is not None:
                    return bumped
                # the Event was deleted server-side (namespace sweep, GC):
                # forget the stale name and record a fresh one
                with self._mu:
                    if self._seen.get(dedup) == existing_name:
                        del self._seen[dedup]
            name = f"{meta.name(involved)}.{meta.new_uid()[:13]}"
            ev = self.client.events.create({
                "apiVersion": "v1", "kind": "Event",
                "metadata": {"name": name, "namespace": ns},
                "involvedObject": {
                    "kind": involved.get("kind", ""),
                    "namespace": ns,
                    "name": meta.name(involved),
                    "uid": meta.uid(involved),
                },
                "reason": reason, "message": message, "type": event_type,
                "source": {"component": self.component},
                "firstTimestamp": meta.now_rfc3339(),
                "lastTimestamp": meta.now_rfc3339(),
                "count": 1,
            }, ns)
            with self._mu:
                self._seen[dedup] = name
            return ev
        except errors.StatusError:
            return None

    def _bump(self, name: str, ns: str) -> Optional[dict]:
        try:
            cur = self.client.events.get(name, ns)
            cur["count"] = int(cur.get("count", 1)) + 1
            cur["lastTimestamp"] = meta.now_rfc3339()
            return self.client.events.update(cur, ns)
        except errors.StatusError:
            return None
