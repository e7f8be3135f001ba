"""Roofline analysis of the port: the three-term model over H100
constants, an eager flop/byte/collective counter, the ring model of
collective bytes and the report (the reference's :mod:`repro.roofline`,
with ``H100`` in ``V5E``'s place)."""
from repro_torch.roofline.collectives import (CollectiveOp, collective_bytes,
                                              parse_collectives)
from repro_torch.roofline.model import (H100, Hardware, RooflineTerms,
                                        model_flops_decode,
                                        model_flops_train, roofline_terms,
                                        solver_terms)
from repro_torch.roofline.report import format_table, load_results, one_liner
from repro_torch.roofline.torch_cost import CostWalk, count_torch, counting

__all__ = ["CollectiveOp", "collective_bytes", "parse_collectives",
           "H100", "Hardware", "RooflineTerms", "roofline_terms",
           "model_flops_train", "model_flops_decode", "format_table",
           "load_results", "one_liner", "solver_terms", "CostWalk",
           "count_torch", "counting"]
