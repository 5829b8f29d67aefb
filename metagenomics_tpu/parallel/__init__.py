"""Multi-chip scaling: device meshes and sharded overlap detection.

The reference is strictly single-threaded (SURVEY.md §2.3); this package is
where the framework adds its scaling axes:

* ``dp``  — read/candidate batches sharded across devices (data parallel)
* ``ix``  — the l-mer index sharded by key range across devices

Candidate matching is a join between the two: every dp shard's queries visit
every ix shard's index slice; per-shard partial results are combined with
psum/all_gather over the device interconnect (the moral equivalent of the
reference's hash-table probe loop, HashTable.cpp:202-221, turned into an
SPMD collective).
"""

from .mesh import make_mesh
from .launcher import initialize_distributed
from .sharded import ShardedOverlapPipeline

__all__ = ["make_mesh", "initialize_distributed", "ShardedOverlapPipeline"]
