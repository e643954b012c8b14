"""Multi-chip / multi-host execution: meshes, shuffles, distributed plans.

The reference is single-process (SURVEY.md §2e); its intra-process
repartition (DataFusion RepartitionExec, file regrouping in
exon_file_scan_config.rs:79-110) maps here to SPMD execution over a
jax.sharding.Mesh with all_to_all hash-partition shuffles.
"""

from .mesh import make_mesh, default_mesh
from .shuffle import hash_partition_shuffle, distributed_group_count
