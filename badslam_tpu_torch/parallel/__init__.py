"""Distribution: the surfel store sharded over a mesh of devices
(``spmd``: the mesh and its collectives; ``sharded_ba``: the sharded BA
steps)."""
