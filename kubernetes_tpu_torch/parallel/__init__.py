"""Node-axis sharding of the single cluster: the mesh (mesh.py), the node
axis each shard's engines reduce over (axis.py) and the multi-device dryrun
(dryrun.py)."""
