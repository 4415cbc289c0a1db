"""Parameter definitions and initialisers for every model family: dense,
MoE, SSM, hybrid, VLM and encoder-decoder.

``model_def`` yields the same tree paths and shapes as the JAX package's
``models/params.py``: a nested dict whose layer leaves are stacked on a
leading layer axis.  Parameters are plain dicts of tensors, so a tree of
JAX arrays converts leaf by leaf (``from_reference``) and the tests can
drive both packages with the same weights.

An MoE model's attention layers hold ``moe`` (router and stacked experts)
in place of ``mlp``.  A hybrid model (``cfg.block_pattern``) stacks its
repeating groups under ``groups`` (``b{i}_{type}``, stacked over the
groups) and keeps the remainder layers under ``tail`` (``t{i}_{type}``,
unstacked), as the JAX tree does.  A VLM is the dense tree (qwen2-vl-2b
ties its embeddings).  An encoder-decoder model stacks its encoder layers
under ``enc_layers`` (self-attention and MLP) and its decoder layers under
``dec_layers`` (self-attention, ``cross`` attention over the encoder's
output, MLP), with ``enc_norm`` after the encoder.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"       # fan_in | zeros | ones | const:<v> | normal:<std>

    def stacked(self, n: int) -> "ParamDef":
        return ParamDef((n,) + self.shape, ("layer",) + self.axes, self.init)


def _attn_def(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, Hq, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": ParamDef((D, Hq, dh), ("embed", "heads", None)),
            "wk": ParamDef((D, Hkv, dh), ("embed", "kv_heads", None)),
            "wv": ParamDef((D, Hkv, dh), ("embed", "kv_heads", None)),
            "wo": ParamDef((Hq, dh, D), ("heads", None, "embed"))}


def _glu(cfg: ModelConfig) -> bool:
    return cfg.activation in ("swiglu", "gelu_glu", "relu_glu")


def _mlp_def(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, F = cfg.d_model, cfg.d_ff
    wi = ParamDef((D, 2, F), ("embed", None, "ff")) if _glu(cfg) else \
        ParamDef((D, F), ("embed", "ff"))
    return {"wi": wi, "wo": ParamDef((F, D), ("ff", "embed"))}


def _moe_def(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    wi = ParamDef((E, D, 2, F), ("expert", "embed", None, "ff")) \
        if _glu(cfg) else ParamDef((E, D, F), ("expert", "embed", "ff"))
    return {"router": ParamDef((D, E), ("embed", None)), "wi": wi,
            "wo": ParamDef((E, F, D), ("expert", "ff", "embed"))}


def _rglru_def(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, W, K = cfg.d_model, cfg.lru_width, cfg.conv_width
    return {
        "w_gate": ParamDef((D, W), ("embed", "lru")),
        "w_in": ParamDef((D, W), ("embed", "lru")),
        "conv_w": ParamDef((K, W), (None, "lru"), "normal:0.05"),
        "conv_b": ParamDef((W,), ("lru",), "zeros"),
        "w_a": ParamDef((W, W), (None, "lru"), "normal:0.01"),
        "w_x": ParamDef((W, W), (None, "lru"), "normal:0.01"),
        "lam": ParamDef((W,), ("lru",), "const:-5.0"),
        "w_out": ParamDef((W, D), ("lru", "embed")),
    }


def _ssd_def(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, di, K = cfg.d_model, cfg.d_inner, cfg.conv_width
    GN, H = cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    return {
        "wz": ParamDef((D, di), ("embed", "ssd_inner")),
        "wx": ParamDef((D, di), ("embed", "ssd_inner")),
        "wB": ParamDef((D, GN), ("embed", "ssd_bc")),
        "wC": ParamDef((D, GN), ("embed", "ssd_bc")),
        "wdt": ParamDef((D, H), ("embed", "ssd_heads")),
        "conv_x": ParamDef((K, di), (None, "ssd_inner"), "normal:0.05"),
        "bx": ParamDef((di,), ("ssd_inner",), "zeros"),
        "conv_B": ParamDef((K, GN), (None, "ssd_bc"), "normal:0.05"),
        "bB": ParamDef((GN,), ("ssd_bc",), "zeros"),
        "conv_C": ParamDef((K, GN), (None, "ssd_bc"), "normal:0.05"),
        "bC": ParamDef((GN,), ("ssd_bc",), "zeros"),
        "A_log": ParamDef((H,), ("ssd_heads",), "const:0.0"),
        "dt_bias": ParamDef((H,), ("ssd_heads",), "const:-2.0"),
        "D_skip": ParamDef((H,), ("ssd_heads",), "ones"),
        "norm": ParamDef((di,), ("ssd_inner",), "ones"),
        "out_proj": ParamDef((di, D), ("ssd_inner", "embed")),
    }


def layer_def(cfg: ModelConfig, layer_type: str) -> Dict:
    D = cfg.d_model
    ln = lambda: ParamDef((D,), (None,), "ones")
    if layer_type == "attn":
        ffn = {"moe": _moe_def(cfg)} if cfg.n_experts else \
            {"mlp": _mlp_def(cfg)}
        return {"ln1": ln(), "attn": _attn_def(cfg), "ln2": ln(), **ffn}
    if layer_type == "rec":
        return {"ln1": ln(), "rec": _rglru_def(cfg), "ln2": ln(),
                "mlp": _mlp_def(cfg)}
    if layer_type == "ssd":
        return {"ln": ln(), "ssd": _ssd_def(cfg)}
    if layer_type == "enc":
        return {"ln1": ln(), "attn": _attn_def(cfg), "ln2": ln(),
                "mlp": _mlp_def(cfg)}
    if layer_type == "dec":
        return {"ln1": ln(), "attn": _attn_def(cfg), "ln2": ln(),
                "cross": _attn_def(cfg), "ln3": ln(), "mlp": _mlp_def(cfg)}
    raise ValueError(layer_type)


def hybrid_structure(cfg: ModelConfig):
    """(group pattern, n_groups, tail layer types) for pattern-based
    models."""
    types = cfg.layer_types()
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    return cfg.block_pattern, n_groups, types[n_groups * period:]


def hybrid_layer_names(cfg: ModelConfig) -> Dict[str, Dict[str, str]]:
    """A hybrid model's layer names under ``groups`` and ``tail``, each to
    its layer type."""
    pattern, _, tail = hybrid_structure(cfg)
    return {"groups": {f"b{i}_{t}": t for i, t in enumerate(pattern)},
            "tail": {f"t{i}_{t}": t for i, t in enumerate(tail)}}


def model_def(cfg: ModelConfig) -> Dict:
    D, V, L = cfg.d_model, cfg.vocab_padded, cfg.n_layers
    out: Dict = {"embed": ParamDef((V, D), ("vocab", None), "normal:0.02"),
                 "final_norm": ParamDef((D,), (None,), "ones")}
    if not cfg.tie_embeddings:
        out["head"] = ParamDef((D, V), (None, "vocab"))
    if cfg.family == "encdec":
        out["enc_layers"] = tree_map(lambda p: p.stacked(cfg.enc_layers),
                                     layer_def(cfg, "enc"))
        out["dec_layers"] = tree_map(lambda p: p.stacked(cfg.dec_layers),
                                     layer_def(cfg, "dec"))
        out["enc_norm"] = ParamDef((D,), (None,), "ones")
        return out
    if cfg.block_pattern:
        _, n_groups, _ = hybrid_structure(cfg)
        names = hybrid_layer_names(cfg)
        group = {n: layer_def(cfg, t) for n, t in names["groups"].items()}
        out["groups"] = tree_map(lambda p: p.stacked(n_groups), group)
        out["tail"] = {n: layer_def(cfg, t)
                       for n, t in names["tail"].items()}
        return out
    layer = layer_def(cfg, cfg.layer_types()[0])
    out["layers"] = tree_map(lambda p: p.stacked(L), layer)
    return out


# top-level trees whose leaves are stacked on a leading layer (or group) axis
STACKED = ("layers", "groups", "enc_layers", "dec_layers")


def tree_map(fn, tree, *rest):
    """``fn`` applied to every leaf of a nested dict (and the matching
    leaves of the dicts ``rest``, of the same structure), same
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def logical_axes(cfg: ModelConfig) -> Dict:
    """The parameter tree with each leaf's logical axis names (a tuple,
    None for a replicated axis), mapped to mesh axes by
    ``launch.sharding``."""
    return tree_map(lambda p: p.axes, model_def(cfg))


def param_shapes(cfg: ModelConfig) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Tree path -> shape for every parameter leaf."""
    return {path: p.shape for path, p in _leaves(model_def(cfg))}


def param_bytes(cfg: ModelConfig) -> int:
    itemsize = torch.empty((), dtype=torch_dtype(cfg.param_dtype)).element_size()
    return sum(math.prod(s) * itemsize for s in param_shapes(cfg).values())


def n_params(cfg: ModelConfig) -> int:
    return sum(math.prod(s) for s in param_shapes(cfg).values())


def _const(init: str) -> Optional[float]:
    """The fill value of a constant leaf (zeros, ones, const:<v>), else
    None."""
    if init.startswith("const:"):
        return float(init.split(":")[1])
    return {"zeros": 0.0, "ones": 1.0}.get(init)


def _std(path: Tuple[str, ...], shape: Tuple[int, ...], init: str) -> float:
    """Init scale of one (unstacked) leaf: the fixed std of ``normal:``
    leaves, else 1/sqrt(fan-in) over the dims the projection contracts —
    the first, (heads, head_dim) for the attention outputs (self and
    cross), the second (after the expert axis) for an expert's ``wi`` and
    ``wo``."""
    if init.startswith("normal:"):
        return float(init.split(":")[1])
    if path[-2:] in (("attn", "wo"), ("cross", "wo")):
        fan_in = shape[0] * shape[1]
    elif path[-2:] in (("moe", "wi"), ("moe", "wo")):
        fan_in = shape[1]
    else:
        fan_in = shape[0]
    return fan_in ** -0.5


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict:
    """Random weights on ``device`` from ``generator`` (seeded 0 when not
    given).  The draws differ from ``jax.random`` for the same seed; tests
    that compare the packages carry weights across with ``from_reference``.
    Stacked leaves are filled one layer slice at a time so no full-size
    float32 temporary is ever allocated."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = torch_dtype(cfg.param_dtype)
    defs = model_def(cfg)
    out: Dict = {}
    for path, p in _leaves(defs):
        t = torch.empty(p.shape, dtype=dtype, device=device)
        const = _const(p.init)
        if const is not None:
            t.fill_(const)
        elif path[0] in STACKED:
            std = _std(path, p.shape[1:], p.init)
            for i in range(p.shape[0]):
                t[i].normal_(0.0, std, generator=generator)
        else:
            t.normal_(0.0, _std(path, p.shape, p.init), generator=generator)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def to_tensor(a, device) -> torch.Tensor:
    """One numpy (or numpy-convertible) leaf -> tensor on ``device``;
    bfloat16 leaves (numpy's ml_dtypes) cross as their raw 16 bits."""
    a = np.array(a)             # a writable copy: JAX arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def from_reference(params_np, device="cuda") -> Dict:
    """The JAX package's parameter tree (leaves as numpy or JAX arrays)
    -> the port's dict of tensors, key path by key path."""
    if isinstance(params_np, dict):
        return {k: from_reference(v, device) for k, v in params_np.items()}
    return to_tensor(params_np, torch.device(device))
