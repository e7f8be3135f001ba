"""Serving layer of the torch port: the continuous-batching
:class:`~repro_torch.serve.solver_engine.SolverEngine` for linear systems,
and the slot-based LM :class:`~repro_torch.serve.engine.DecodeEngine` with
its KV-cache helpers (:mod:`~repro_torch.serve.kv_cache`) and the int8 KV
cache (:mod:`~repro_torch.serve.quant_cache`)."""
from repro_torch.serve.engine import DecodeEngine, EngineConfig
from repro_torch.serve.kv_cache import (bytes_per_slot, cache_bytes, init_cache,
                                        slot_insert, slot_view)
from repro_torch.serve.quant_cache import (QuantAttnCache, attn_decode_quant,
                                           dequantize_kv, init_quant_cache,
                                           quantize_kv)
from repro_torch.serve.solver_engine import SolverEngine, SolverEngineConfig

__all__ = ["DecodeEngine", "EngineConfig", "SolverEngine",
           "SolverEngineConfig", "bytes_per_slot", "cache_bytes",
           "init_cache", "slot_insert", "slot_view", "QuantAttnCache",
           "init_quant_cache", "attn_decode_quant", "quantize_kv",
           "dequantize_kv"]
