"""Collective-byte accounting from recorded ``torch.distributed`` ops
(the port of :mod:`repro.roofline.hlo_bytes`, which parses HLO text).

:func:`repro_torch.roofline.torch_cost.count_torch` records each c10d
collective it sees as ``(kind, result_bytes, group_size)``, with the
reference's kind names.  The per-op model of bytes on the wire per
device is the reference's (ring algorithms, the standard cost):

  =====================  ==========================================
  op                     bytes on the wire per device
  =====================  ==========================================
  all-gather             (g−1)/g · result_bytes   (receives all shards)
  reduce-scatter         (g−1)/g · operand_bytes ≈ (g−1)/g · g·result
  all-reduce             2 · (g−1)/g · result_bytes (RS + AG)
  all-to-all             (g−1)/g · result_bytes
  collective-permute     result_bytes
  =====================  ==========================================

A broadcast is priced as an all-gather.  One device (g = 1) moves
nothing but point-to-point traffic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["CollectiveOp", "parse_collectives", "collective_bytes",
           "wire_bytes"]


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    kind: str
    result_bytes: int       # per-device result payload
    group_size: int
    wire_bytes: int         # modeled bytes on the wire per device


def wire_bytes(kind: str, result_bytes: int, g: int) -> float:
    """Modeled bytes on the wire per device for one op."""
    frac = (g - 1) / g if g > 1 else 0.0
    if kind == "all-reduce":
        return 2 * frac * result_bytes
    if kind == "reduce-scatter":
        return frac * result_bytes * g      # operand = g × result
    if kind == "collective-permute":
        return float(result_bytes)
    return frac * result_bytes              # all-gather / all-to-all


def parse_collectives(records: Iterable[Tuple[str, int, Optional[int]]],
                      default_group: int = 1) -> List[CollectiveOp]:
    """Turn ``(kind, result_bytes, group_size)`` records into priced ops;
    a group size of ``None`` takes ``default_group``."""
    ops: List[CollectiveOp] = []
    for kind, rb, g in records:
        g = default_group if g is None else int(g)
        ops.append(CollectiveOp(kind, int(rb), g,
                                int(wire_bytes(kind, int(rb), g))))
    return ops


def collective_bytes(ops: Iterable[CollectiveOp]) -> Dict[str, float]:
    """Aggregate per-device collective traffic."""
    ops = list(ops)
    by_kind: Dict[str, float] = {}
    for op in ops:
        by_kind[op.kind] = by_kind.get(op.kind, 0) + op.wire_bytes
    return {
        "total_wire_bytes": float(sum(o.wire_bytes for o in ops)),
        "n_ops": len(ops),
        "by_kind": by_kind,
    }
