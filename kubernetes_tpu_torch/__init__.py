"""kubernetes_tpu_torch — the PyTorch/CUDA port of kubernetes_tpu's scheduler.

The same Filter → Score → assume cycle over a (pod-class × node) lattice, as
PyTorch tensor programs on an NVIDIA GPU, with hand-written CUDA kernels
(csrc/) where the wave engine needs them. The JAX package stays the
reference: each ported part is held against it on the same encoded input.

Layers (module names follow the JAX package's, so each has a counterpart):
  api/     — object model (copied: no JAX in it)
  state/   — vocab interning, encoding (copied), tensor schemas + the move
             onto the device (state/arrays.py tables_to_torch), the
             scheduler cache with its resident device tensors (state/cache.py)
  ops/     — Filter masks, Score rows, the engines (waves, scan, gang,
             preemption), the CUDA kernel wrappers
  sched/   — the batch cycle (BatchScheduler), the serving Scheduler on the
             resident cache (state/cache.py), its queue and governor, the
             preemption driver (Preemptor), the configuration loader
             (sched/config.py)
  framework/ — the scheduling-framework runtime and in-tree plugins
  extender/ — the scheduler-extender HTTP boundary (backend, server, client)
  sched/server.py — the scheduler process (SchedulerServer) over the API
  fleet/   — K tenant clusters per tick on one device (FleetServer): the
             stacked tenant state, the DRF quota clamp, the tenant watch
             plane over client/watchmux.py
  apiserver/, client/, storage/, machinery/ — the apiserver the process
             binds through, its client, the versioned store with its watch
             hub, and the object machinery (copied: no JAX in them)
  component/ — the metrics registry and feature gates (copied)
  models/  — the benchmark workloads (copied)
"""

__version__ = "0.1.0"

from .api.types import (  # noqa: F401
    Affinity,
    HostPort,
    LabelSelector,
    Node,
    NodeSelector,
    NodeSelectorTerm,
    Op,
    Pod,
    PodAffinityTerm,
    Requirement,
    Resources,
    Taint,
    TaintEffect,
    Toleration,
    TolerationOp,
    TopologySpreadConstraint,
    UnsatisfiableAction,
)
from .sched.cycle import BatchScheduler, CycleResult  # noqa: F401
from .sched.preemption import CacheEvictor, Preemptor  # noqa: F401
from .sched.queue import PriorityQueue  # noqa: F401
from .sched.scheduler import RecordingBinder, Scheduler  # noqa: F401
from .state.cache import SchedulerCache  # noqa: F401
