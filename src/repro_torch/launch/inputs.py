"""``input_specs``: stand-ins for every model input, with their specs.

The JAX package's ``launch/inputs.py``: each leaf is a ``StandIn`` — a
``meta`` tensor of the input's shape and type (no memory) and, on a mesh,
the ``NamedSharding`` of its ``PartitionSpec`` — where JAX has a
``ShapeDtypeStruct`` with a sharding.  Decode stand-ins include the whole
cache for a ``shape.seq_len``-deep context (ring-buffer-bounded for
windowed, hybrid and SSM models), from ``decode.abstract_cache``.  The
batch axes are ("pod", "data") on a mesh, and the batch is replicated
when B does not divide over them (``_batch_tuple``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import sharding as sh
from repro_torch.launch.sharding import P
from repro_torch.models import decode as dec
from repro_torch.models.params import tree_map

ENCDEC_SRC_LEN = 4096          # decode-time encoder context (audio frames)


@dataclasses.dataclass(frozen=True)
class StandIn:
    """An input's ``meta`` tensor and, on a mesh, its sharding."""
    value: torch.Tensor
    sharding: Optional[sh.NamedSharding] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype

    @property
    def spec(self) -> Optional[sh.PartitionSpec]:
        return None if self.sharding is None else self.sharding.spec


def _sds(shape, dtype, mesh=None, spec=None) -> StandIn:
    value = torch.empty(shape, dtype=dtype, device="meta")
    if mesh is None:
        return StandIn(value)
    return StandIn(value, sh.NamedSharding(mesh, spec))


def _batch_tuple(mesh, B: int):
    """Batch mesh axes, or () when B isn't divisible (replicate batch)."""
    if mesh is None:
        return ("data",)
    b = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    shards = 1
    for a in b:
        shards *= mesh.shape[a]
    return b if (B % shards == 0 and B >= shards) else ()


def seq_split(cfg: ModelConfig, S: int) -> Tuple[int, int]:
    """(text_len, vision_len) for VLM; (tgt_len, src_len) for enc-dec."""
    if cfg.family == "vlm":
        sv = int(S * cfg.vision_frac)
        return S - sv, sv
    if cfg.family == "encdec":
        return S // 2, S // 2
    return S, 0


def train_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh=None) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    b = _batch_tuple(mesh, B)
    i32, f32, bf16 = torch.int32, torch.float32, torch.bfloat16
    out = {}
    if cfg.family == "vlm":
        st, sv = seq_split(cfg, S)
        out["tokens"] = _sds((B, st), i32, mesh, P(b, None))
        out["vision_embeds"] = _sds((B, sv, cfg.d_model), bf16, mesh,
                                    P(b, None, None))
        out["position_ids"] = _sds((3, B, S), i32, mesh, P(None, b, None))
        out["targets"] = _sds((B, S), i32, mesh, P(b, None))
        out["mask"] = _sds((B, S), f32, mesh, P(b, None))
    elif cfg.family == "encdec":
        st, ss = seq_split(cfg, S)
        out["frame_embeds"] = _sds((B, ss, cfg.d_model), bf16, mesh,
                                   P(b, None, None))
        out["tokens"] = _sds((B, st), i32, mesh, P(b, None))
        out["targets"] = _sds((B, st), i32, mesh, P(b, None))
        out["mask"] = _sds((B, st), f32, mesh, P(b, None))
    else:
        out["tokens"] = _sds((B, S), i32, mesh, P(b, None))
        out["targets"] = _sds((B, S), i32, mesh, P(b, None))
        out["mask"] = _sds((B, S), f32, mesh, P(b, None))
    return out


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh=None) -> Dict:
    t = train_inputs(cfg, shape, mesh)
    t.pop("targets", None)
    t.pop("mask", None)
    return t


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh=None) -> Dict:
    """(cache, tokens, pos[, extras]) stand-ins for one serve_step."""
    B, S = shape.global_batch, shape.seq_len
    b = _batch_tuple(mesh, B)
    src = ENCDEC_SRC_LEN if cfg.family == "encdec" else 0
    cache = dec.abstract_cache(cfg, B, S, src_len=src)
    if mesh is None:
        cache = tree_map(StandIn, cache)
    else:
        specs = sh.cache_specs(cfg, mesh, cache)
        cache = tree_map(lambda l, s: StandIn(l, sh.NamedSharding(mesh, s)),
                         cache, specs)
    out = {
        "cache": cache,
        "tokens": _sds((B, 1), torch.int32, mesh, P(b, None)),
        "pos": _sds((B,), torch.int32, mesh, P(b)),
    }
    if cfg.rope_type == "mrope":
        out["extras"] = {"position_ids": _sds((3, B, 1), torch.int32, mesh,
                                              P(None, b, None))}
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None) -> Dict:
    if shape.kind == "train":
        return train_inputs(cfg, shape, mesh)
    if shape.kind == "prefill":
        return prefill_inputs(cfg, shape, mesh)
    return decode_inputs(cfg, shape, mesh)
