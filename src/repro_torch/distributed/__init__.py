"""Distribution layer of the port: the sharding rules (FSDP × TP × EP × DP
on DTensor, :mod:`~repro_torch.distributed.sharding`), the activation
hints (:mod:`~repro_torch.distributed.hints`) and the row-distributed CG
on ``torch.distributed`` (:mod:`~repro_torch.distributed.cg_dist`).  Lane
sharding of the batched solver is :mod:`repro_torch.core.shard`.
Importing it starts no process group."""
from repro_torch.distributed import hints
from repro_torch.distributed.cg_dist import DistCG, make_dist_solver
from repro_torch.distributed.hints import DATA, MODEL, hint, sharding_hints
from repro_torch.distributed.sharding import (activation_spec, batch_specs,
                                              cache_specs, data_axes,
                                              named_shardings, param_specs)

__all__ = ["DistCG", "make_dist_solver", "param_specs", "batch_specs",
           "cache_specs", "data_axes", "named_shardings", "activation_spec",
           "hints", "hint", "sharding_hints", "DATA", "MODEL"]
