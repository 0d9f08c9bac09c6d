"""Fleet serving: one resident scheduler, K virtual tenant clusters (port of
the JAX package's fleet/, single device).

The serving machinery (sched/, state/) serves ONE cluster. This package
multiplexes K tenant clusters onto it: per-tenant `ClusterTables` stack
into a leading tenant axis on the device (`tables.py`), one dispatch per
engine group per tick runs every tenant's cycle on its view of the stack
(`cycle.py`), dominant-resource-fairness quotas clamp admission as tensor
ops over the stacked batch (`quota.py`), and `server.py` owns the
per-tenant caches, queues and ledgers, the commit loop and the watch plane.
The fleet mesh is not ported (ROADMAP A13b).
"""

from .server import (FleetServer, FleetTenant, FleetTickStats,
                     FleetWatchPlane, tenant_ledger)

__all__ = ["FleetServer", "FleetTenant", "FleetTickStats",
           "FleetWatchPlane", "tenant_ledger"]
