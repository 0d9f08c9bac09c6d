"""Scheduler-extender boundary: the device lattice as an out-of-process
extender (server) and extender webhooks callable from our own scheduler
(client) — the port of the JAX package's extender/, with the same exports.
Reference: pkg/scheduler/core/extender.go + apis/extender/v1/types.go."""

from .backend import ExtenderBackend
from .client import ExtenderConfig, ExtenderError, HTTPExtender
from .server import ExtenderServer
from .wire import (
    ExtenderArgs,
    ExtenderBindingArgs,
    ExtenderBindingResult,
    ExtenderFilterResult,
    ExtenderPreemptionArgs,
    ExtenderPreemptionResult,
    HostPriority,
    MAX_EXTENDER_PRIORITY,
    MetaVictims,
    Victims,
)

__all__ = [
    "ExtenderBackend", "ExtenderConfig", "ExtenderError", "HTTPExtender",
    "ExtenderServer", "ExtenderArgs", "ExtenderBindingArgs",
    "ExtenderBindingResult", "ExtenderFilterResult", "ExtenderPreemptionArgs",
    "ExtenderPreemptionResult", "HostPriority", "MAX_EXTENDER_PRIORITY",
    "MetaVictims", "Victims",
]
