"""HTTPExtender — the scheduler-side client for out-of-process extenders.

Analog of pkg/scheduler/core/extender.go: our scheduler can itself call
external extenders during its cycle (Filter after the lattice mask, Prioritize
folded into the weighted score, Bind delegation, ProcessPreemption), so a
migration can run the batched scheduler *with* existing extender webhooks
intact. A copy of the JAX package's extender/client.py.

Config mirrors the legacy Extender policy struct
(apis/config/legacy_types.go:75-111): urlPrefix, per-verb paths (empty = verb
unsupported), weight, httpTimeout, nodeCacheCapable, managedResources,
ignorable (:153-157 — errors from ignorable extenders don't fail scheduling).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..api.types import Pod, Node
from ..api.v1 import node_to_v1, pod_to_v1
from .wire import (
    ExtenderArgs,
    ExtenderBindingArgs,
    ExtenderBindingResult,
    ExtenderFilterResult,
    ExtenderPreemptionArgs,
    ExtenderPreemptionResult,
    HostPriority,
    MetaVictims,
    Victims,
)


@dataclass
class ExtenderConfig:
    """legacy_types.go:75 Extender (TLS options omitted: http only here)."""

    url_prefix: str
    filter_verb: str = ""
    prioritize_verb: str = ""
    preempt_verb: str = ""
    bind_verb: str = ""
    weight: int = 1
    http_timeout: float = 5.0
    node_cache_capable: bool = False
    managed_resources: Tuple[str, ...] = ()
    ignorable: bool = False


class ExtenderError(RuntimeError):
    pass


class HTTPExtender:
    """core/extender.go:97 HTTPExtender."""

    def __init__(self, config: ExtenderConfig) -> None:
        self.config = config

    # -- helpers ---------------------------------------------------------- #

    def _post(self, verb: str, payload: dict):
        """send() (extender.go:424-450): POST JSON, decode JSON."""
        url = self.config.url_prefix.rstrip("/") + "/" + verb
        req = urllib.request.Request(
            url,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.config.http_timeout) as resp:
                if resp.status != 200:
                    raise ExtenderError(f"{url}: HTTP {resp.status}")
                return json.loads(resp.read() or b"{}")
        except (urllib.error.URLError, OSError) as e:
            raise ExtenderError(f"{url}: {e}") from e

    def is_interested(self, pod: Pod) -> bool:
        """IsInterested (extender.go:454-470)."""
        if not self.config.managed_resources:
            return True
        managed = set(self.config.managed_resources)
        return any(name in managed for name, _ in pod.requests.scalars)

    @property
    def is_binder(self) -> bool:
        return bool(self.config.bind_verb)

    @property
    def supports_preemption(self) -> bool:
        return bool(self.config.preempt_verb)

    # -- verbs ------------------------------------------------------------ #

    def filter(
        self, pod: Pod, nodes: Sequence[Node]
    ) -> Tuple[List[str], Dict[str, str]]:
        """Filter (extender.go:289-353): returns (feasible node names,
        failed-nodes map). No-op passthrough when the verb is unset."""
        names = [n.name for n in nodes]
        if not self.config.filter_verb:
            return names, {}
        args = ExtenderArgs(
            pod=pod_to_v1(pod),
            nodes=None if self.config.node_cache_capable
            else [node_to_v1(n) for n in nodes],
            node_names=names if self.config.node_cache_capable else None,
        )
        res = ExtenderFilterResult.from_json(self._post(self.config.filter_verb,
                                                        args.to_json()))
        if res.error:
            raise ExtenderError(res.error)
        if self.config.node_cache_capable:
            return list(res.node_names or []), dict(res.failed_nodes)
        return ([n["metadata"]["name"] for n in res.nodes or []],
                dict(res.failed_nodes))

    def prioritize(
        self, pod: Pod, nodes: Sequence[Node]
    ) -> Tuple[Dict[str, int], int]:
        """Prioritize (extender.go:355-395): returns ({node: score 0-10},
        weight). Zero scores when the verb is unset (same as the reference)."""
        if not self.config.prioritize_verb:
            return {n.name: 0 for n in nodes}, 1
        args = ExtenderArgs(
            pod=pod_to_v1(pod),
            nodes=None if self.config.node_cache_capable
            else [node_to_v1(n) for n in nodes],
            node_names=[n.name for n in nodes] if self.config.node_cache_capable else None,
        )
        raw = self._post(self.config.prioritize_verb, args.to_json())
        scores = {hp.host: hp.score for hp in (HostPriority.from_json(o) for o in raw)}
        return scores, int(self.config.weight)

    def process_preemption(
        self,
        pod: Pod,
        victims_by_node: Dict[str, List[Pod]],
        uid_by_key: Optional[Dict[str, str]] = None,
    ) -> Dict[str, List[str]]:
        """ProcessPreemption (extender.go:166-230): returns the surviving
        {node: victim keys} map."""
        if not self.config.preempt_verb:
            return {k: [p.key for p in v] for k, v in victims_by_node.items()}
        if self.config.node_cache_capable:
            args = ExtenderPreemptionArgs(
                pod=pod_to_v1(pod),
                node_name_to_meta_victims={
                    node: MetaVictims(pods=[p.uid for p in pods])
                    for node, pods in victims_by_node.items()
                },
            )
        else:
            args = ExtenderPreemptionArgs(
                pod=pod_to_v1(pod),
                node_name_to_victims={
                    node: Victims(pods=[pod_to_v1(p) for p in pods])
                    for node, pods in victims_by_node.items()
                },
            )
        res = ExtenderPreemptionResult.from_json(
            self._post(self.config.preempt_verb, args.to_json()))
        uid_to_key = {}
        for pods in victims_by_node.values():
            for p in pods:
                uid_to_key[p.uid] = p.key
        return {
            node: [uid_to_key.get(u, u) for u in mv.pods]
            for node, mv in res.node_name_to_meta_victims.items()
        }

    def bind(self, pod: Pod, node_name: str) -> None:
        """Bind (extender.go:397-422)."""
        if not self.config.bind_verb:
            raise ExtenderError("extender does not support bind")
        args = ExtenderBindingArgs(
            pod_name=pod.name, pod_namespace=pod.namespace,
            pod_uid=pod.uid, node=node_name,
        )
        res = ExtenderBindingResult.from_json(
            self._post(self.config.bind_verb, args.to_json()))
        if res.error:
            raise ExtenderError(res.error)
