"""Distribution layer of the port: the row-distributed CG on
``torch.distributed`` (:mod:`repro_torch.distributed.cg_dist`).  Lane
sharding of the batched solver is :mod:`repro_torch.core.shard`.
Importing it starts no process group."""
from repro_torch.distributed.cg_dist import DistCG, make_dist_solver

__all__ = ["DistCG", "make_dist_solver"]
