"""Service dataplane: the kube-proxy analog.

The port's copy of the JAX package's proxy/: analog of SURVEY.md layer 9
(`pkg/proxy`, `cmd/kube-proxy`). Host code only: no device state.
"""

from ..proxy.proxier import Proxier, RuleTable

__all__ = ["Proxier", "RuleTable"]
