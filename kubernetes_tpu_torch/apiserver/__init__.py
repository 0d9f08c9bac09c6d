"""The apiserver the scheduler process binds through: registry stores, the
default admission chain, the REST engine and its HTTP gateway (the subset of
the JAX package's apiserver/ that the scheduler reaches; its other parts
wait for ROADMAP A11b's second half)."""

from .admission import AdmissionChain, AdmissionPlugin
from .registry import Store, parse_field_selector
from .resources import build_scheme
from .server import APIServer, HTTPGateway, handle_rest

__all__ = ["APIServer", "AdmissionChain", "AdmissionPlugin", "HTTPGateway",
           "Store", "build_scheme", "handle_rest", "parse_field_selector"]
