"""Feature gates (a copy of the JAX package's component/featuregate.py).

Analog of `staging/src/k8s.io/component-base/featuregate` +
`pkg/features/kube_features.go`: named alpha/beta/GA switches parsed from
`--feature-gates=A=true,B=false` strings, queried process-wide.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict

ALPHA = "ALPHA"
BETA = "BETA"
GA = "GA"


@dataclass(frozen=True)
class FeatureSpec:
    default: bool
    pre_release: str = ALPHA
    locked_to_default: bool = False  # GA features that can no longer change


class FeatureGate:
    def __init__(self, known: Dict[str, FeatureSpec]):
        self._mu = threading.Lock()
        self._known = dict(known)
        self._enabled: Dict[str, bool] = {}

    def enabled(self, name: str) -> bool:
        with self._mu:
            if name in self._enabled:
                return self._enabled[name]
            spec = self._known.get(name)
            if spec is None:
                raise KeyError(f"unknown feature gate {name!r}")
            return spec.default

    def set(self, name: str, value: bool) -> None:
        with self._mu:
            spec = self._known.get(name)
            if spec is None:
                raise KeyError(f"unknown feature gate {name!r}")
            if spec.locked_to_default and value != spec.default:
                raise ValueError(f"feature {name} is locked to "
                                 f"{spec.default}")
            self._enabled[name] = value

    def set_from_map(self, overrides: Dict[str, bool]) -> None:
        for k, v in overrides.items():
            self.set(k, v)

    def parse(self, s: str) -> None:
        """--feature-gates=A=true,B=false."""
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, val = part.partition("=")
            self.set(name.strip(), val.strip().lower() in ("true", "1", "t"))

    def known(self) -> Dict[str, FeatureSpec]:
        with self._mu:
            return dict(self._known)


# The gates the reference ships that map onto capabilities we implement
# (pkg/features/kube_features.go; EvenPodsSpread:477 is the headline one)
DEFAULT_FEATURE_GATES = FeatureGate({
    "EvenPodsSpread": FeatureSpec(default=True, pre_release=BETA),
    "TaintBasedEvictions": FeatureSpec(default=True, pre_release=BETA),
    "NodeLease": FeatureSpec(default=True, pre_release=BETA),
    "ScheduleDaemonSetPods": FeatureSpec(default=True, pre_release=BETA),
    "PodPriority": FeatureSpec(default=True, pre_release=GA,
                               locked_to_default=True),
    "VolumeScheduling": FeatureSpec(default=True, pre_release=GA,
                                    locked_to_default=True),
    # the batch-scheduling additions; names kept as the JAX package has
    # them, so a config written for it loads here unchanged
    "TPUBatchScheduling": FeatureSpec(default=True, pre_release=BETA),
    "TPUPreemption": FeatureSpec(default=True, pre_release=BETA),
})
