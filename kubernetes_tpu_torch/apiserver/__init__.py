"""API server: registry stores + REST engine + HTTP gateway with watch (a
copy of the JAX package's apiserver/).

Analog of SURVEY.md layer 4 (`cmd/kube-apiserver`,
`staging/src/k8s.io/apiserver`, `pkg/registry`).
"""

from .admission import AdmissionChain, AdmissionPlugin
from .auth import AuthGate, RBACAuthorizer, TokenAuthenticator
from .registry import Store, parse_field_selector
from .resources import build_scheme
from .server import APIServer, HTTPGateway, handle_rest

__all__ = ["APIServer", "AdmissionChain", "AdmissionPlugin", "AuthGate",
           "HTTPGateway", "RBACAuthorizer", "Store", "TokenAuthenticator",
           "build_scheme", "handle_rest", "parse_field_selector"]
