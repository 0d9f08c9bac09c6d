"""Shared component infrastructure: metrics, feature gates, tracing, version.

The port's copy of the JAX package's component/: analog of SURVEY.md layer
11 (`staging/src/k8s.io/component-base`). metrics_server.py is imported on
its own (`component.metrics_server`), as in the JAX package.
"""

from ..component.featuregate import (
    ALPHA,
    BETA,
    DEFAULT_FEATURE_GATES,
    FeatureGate,
    FeatureSpec,
    GA,
)
from ..component.metrics import (
    Counter,
    DEFAULT_REGISTRY,
    Gauge,
    Histogram,
    Registry,
)
from ..component.trace import Trace, device_step_marker

# the version the port's apiserver serves (apiserver/server.py VERSION_INFO)
VERSION = {"gitVersion": "v1.17.0-torch.1", "major": "1", "minor": "17+",
           "platform": "torch"}

__all__ = ["ALPHA", "BETA", "Counter", "DEFAULT_FEATURE_GATES",
           "DEFAULT_REGISTRY", "FeatureGate", "FeatureSpec", "GA", "Gauge",
           "Histogram", "Registry", "Trace", "VERSION",
           "device_step_marker"]
