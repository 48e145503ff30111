"""Data parallelism: the mesh, the rank launcher and the collectives
(``mesh.py``), and the multi-rank dry run (``dryrun.py``)."""
from .mesh import (Mesh, all_reduce_mean, is_main, launch, make_mesh,
                   process_group, rank_path, replicate, shard_rows,
                   split_batch)

__all__ = ["Mesh", "all_reduce_mean", "is_main", "launch", "make_mesh",
           "process_group", "rank_path", "replicate", "shard_rows",
           "split_batch"]
