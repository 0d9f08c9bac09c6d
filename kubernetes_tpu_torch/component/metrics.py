"""Metrics: Prometheus-style registry with text exposition.

Analog of `staging/src/k8s.io/component-base/metrics` (the Prometheus
client wrapper every binary shares): Counter/Gauge/Histogram vectors with
label sets, a process-wide default registry, and the text format served at
/metrics (`pkg/scheduler/metrics/metrics.go` registers into exactly this).

Concurrency contract (audited for the telemetry work — the serving loop, the
supervisor's watchdog worker, the background prober, the prewarmer's
compile thread and the consistency sweeper all touch these concurrently):
every read AND write of a metric's state happens under that metric's own
`_mu`, so increments are never lost (tests/test_telemetry.py hammers this).
Lock ordering is registry → metric only (`expose_text` holds the registry
lock while each metric exposes under its own); metric methods never take
the registry lock, so the ordering cannot invert.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0)


def escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping (text exposition format
    spec: backslash, double-quote and line-feed MUST be escaped — a tenant
    name or pod key containing any of them would otherwise corrupt the
    whole exposition for every scraper)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def escape_help(text: str) -> str:
    """HELP-line escaping per the exposition format: backslash and
    line-feed only (quotes are legal in HELP text)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Sequence[str]):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._mu = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        return tuple(labels.get(n, "") for n in self.label_names)

    def _header(self) -> List[str]:
        """Conformant `# HELP` / `# TYPE` preamble (HELP skipped when the
        help text is empty — the format allows absence, not a blank)."""
        out = []
        if self.help:
            out.append(f"# HELP {self.name} {escape_help(self.help)}")
        out.append(f"# TYPE {self.name} {self.TYPE}")
        return out

    @staticmethod
    def _fmt_labels(names: Sequence[str], values: Sequence[str],
                    extra: str = "") -> str:
        pairs = [f'{n}="{escape_label_value(v)}"'
                 for n, v in zip(names, values)]
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter(_Metric):
    TYPE = "counter"

    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._mu:
            k = self._key(labels)
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        with self._mu:
            return self._values.get(self._key(labels), 0.0)

    def total(self) -> float:
        """Sum over every label combination (tests/bench assert aggregate
        outcomes — e.g. `drf_clamped >= 1` across all tenants — without
        enumerating the label space)."""
        with self._mu:
            return sum(self._values.values())

    def expose(self) -> List[str]:
        with self._mu:
            out = self._header()
            for k, v in sorted(self._values.items()):
                out.append(f"{self.name}"
                           f"{self._fmt_labels(self.label_names, k)} {v}")
            if not self._values and not self.label_names:
                # scalar metrics expose 0 before first touch; labeled vectors
                # must NOT emit a bogus unlabeled series
                out.append(f"{self.name} 0")
            return out


class Gauge(Counter):
    TYPE = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._mu:
            self._values[self._key(labels)] = value

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram(_Metric):
    TYPE = "histogram"

    def __init__(self, name, help_, label_names=(),
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float, **labels) -> None:
        # counts are stored PER BUCKET (non-cumulative) and accumulated at
        # expose/quantile time: observe is on the per-pod hot path (the
        # e2e latency histogram fires once per Binding), and a Python loop
        # over every bucket per observation was a measurable slice of the
        # telemetry overhead budget — one bisect is not
        with self._mu:
            k = self._key(labels)
            counts = self._counts.setdefault(k, [0] * len(self.buckets))
            i = bisect.bisect_left(self.buckets, value)
            if i < len(counts):
                counts[i] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._totals[k] = self._totals.get(k, 0) + 1

    def observe_many(self, values: Sequence[float], **labels) -> None:
        """Batch observe: one lock acquisition (and one dict resolve) for a
        whole wave's samples. The e2e latency histogram fires once per
        Binding — thousands of times per bulk wave, and the micro-wave
        regime multiplies the wave count on top — and the per-call
        lock+lookup overhead of `observe` was a measurable slice of the
        ≤2% telemetry budget at that rate."""
        if not values:
            return
        bl = self.buckets
        nb = len(bl)
        bis = bisect.bisect_left
        with self._mu:
            k = self._key(labels)
            counts = self._counts.setdefault(k, [0] * nb)
            s = 0.0
            for v in values:
                i = bis(bl, v)
                if i < nb:
                    counts[i] += 1
                s += v
            self._sums[k] = self._sums.get(k, 0.0) + s
            self._totals[k] = self._totals.get(k, 0) + len(values)

    def count(self, **labels) -> int:
        with self._mu:
            return self._totals.get(self._key(labels), 0)

    def sum_value(self, **labels) -> float:
        with self._mu:
            return self._sums.get(self._key(labels), 0.0)

    def quantile(self, q: float, **labels) -> float:
        """Approximate quantile from bucket boundaries (for tests/SLO checks;
        Prometheus computes this server-side with histogram_quantile)."""
        with self._mu:
            k = self._key(labels)
            total = self._totals.get(k, 0)
            if not total:
                return 0.0
            target = q * total
            acc = 0
            for i, b in enumerate(self.buckets):
                acc += self._counts[k][i]
                if acc >= target:
                    return b
            return float("inf")

    def expose(self) -> List[str]:
        with self._mu:
            out = self._header()
            for k in sorted(self._totals):
                acc = 0
                for i, b in enumerate(self.buckets):
                    # no backslashes inside f-string expressions: that is a
                    # Python ≥3.12 feature and this tree must import on 3.10
                    le = 'le="%s"' % b
                    acc += self._counts[k][i]  # cumulative le semantics
                    out.append(
                        f"{self.name}_bucket"
                        f"{self._fmt_labels(self.label_names, k, le)}"
                        f" {acc}")
                le_inf = 'le="+Inf"'
                out.append(f"{self.name}_bucket"
                           f"{self._fmt_labels(self.label_names, k, le_inf)}"
                           f" {self._totals[k]}")
                out.append(f"{self.name}_sum"
                           f"{self._fmt_labels(self.label_names, k)}"
                           f" {self._sums[k]}")
                out.append(f"{self.name}_count"
                           f"{self._fmt_labels(self.label_names, k)}"
                           f" {self._totals[k]}")
            return out


class Registry:
    def __init__(self):
        self._mu = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def register(self, metric: _Metric) -> _Metric:
        with self._mu:
            # idempotent by name (MustRegister panics; we return the existing
            # collector so module reloads in tests stay cheap)
            return self._metrics.setdefault(metric.name, metric)

    def counter(self, name, help_="", labels=()) -> Counter:
        return self.register(Counter(name, help_, labels))  # type: ignore

    def gauge(self, name, help_="", labels=()) -> Gauge:
        return self.register(Gauge(name, help_, labels))  # type: ignore

    def histogram(self, name, help_="", labels=(),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_, labels, buckets))  # type: ignore

    def expose_text(self) -> str:
        with self._mu:
            lines: List[str] = []
            for m in self._metrics.values():
                lines.extend(m.expose())
            return "\n".join(lines) + "\n"


DEFAULT_REGISTRY = Registry()
