"""Fleet serving: one resident scheduler, K virtual tenant clusters (port of
the JAX package's fleet/).

The serving machinery (sched/, state/) serves ONE cluster. This package
multiplexes K tenant clusters onto it: per-tenant `ClusterTables` stack
into a leading tenant axis on the device (`tables.py`), one dispatch per
engine group per tick runs every tenant's cycle on its view of the stack
(`cycle.py`), dominant-resource-fairness quotas clamp admission as tensor
ops over the stacked batch (`quota.py`), and `server.py` owns the
per-tenant caches, queues and ledgers, the commit loop and the watch plane.
On a fleet mesh (parallel/mesh.py FleetMesh) the stack's tenant axis splits
across device rows and, on the tenant × node-shard grid, each tenant's node
planes across its row.
"""

from .server import (FleetServer, FleetTenant, FleetTickStats,
                     FleetWatchPlane, tenant_ledger)

__all__ = ["FleetServer", "FleetTenant", "FleetTickStats",
           "FleetWatchPlane", "tenant_ledger"]
