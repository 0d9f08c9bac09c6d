"""Scheduling-framework plugin runtime (framework/v1alpha1 re-designed for
batched device evaluation) + in-tree plugins + default registry — the
port of the JAX package's framework/, with the same exports."""

from .interface import (
    Code,
    CycleState,
    FilterPlugin,
    MAX_NODE_SCORE,
    MIN_NODE_SCORE,
    PermitPlugin,
    Plugin,
    PostBindPlugin,
    PreBindPlugin,
    PreFilterPlugin,
    BindPlugin,
    ReservePlugin,
    ScorePlugin,
    Status,
    SUCCESS,
    TensorContext,
    UnreservePlugin,
)
from .plugins import (
    build_context,
    default_framework,
    default_plugins,
    default_registry,
)
from .runtime import Framework, PluginSet, Plugins, Registry, merge_plugins

__all__ = [
    "Code", "CycleState", "FilterPlugin", "MAX_NODE_SCORE", "MIN_NODE_SCORE",
    "PermitPlugin", "Plugin", "PostBindPlugin", "PreBindPlugin",
    "PreFilterPlugin", "BindPlugin", "ReservePlugin", "ScorePlugin", "Status",
    "SUCCESS", "TensorContext", "UnreservePlugin", "build_context",
    "default_framework", "default_plugins", "default_registry", "Framework",
    "PluginSet", "Plugins", "Registry", "merge_plugins",
]
