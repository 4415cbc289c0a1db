"""Parameter definitions and initialisers for the dense decoder family.

``model_def`` yields the same tree paths and shapes as the JAX package's
``models/params.py``: a nested dict whose layer leaves are stacked on a
leading layer axis.  Parameters are plain dicts of tensors, so a tree of
JAX arrays converts leaf by leaf (``from_reference``) and the tests can
drive both packages with the same weights.

Only ``family == "dense"`` is ported; the other families raise
``NotImplementedError`` until their slice lands (ROADMAP A8).
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
    init: str = "fan_in"       # fan_in | ones | normal:<std>

    def stacked(self, n: int) -> "ParamDef":
        return ParamDef((n,) + self.shape, self.init)


def _check_family(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            "(ROADMAP A8)")


def _attn_def(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, Hq, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": ParamDef((D, Hq, dh)), "wk": ParamDef((D, Hkv, dh)),
            "wv": ParamDef((D, Hkv, dh)), "wo": ParamDef((Hq, dh, D))}


def _mlp_def(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, F = cfg.d_model, cfg.d_ff
    glu = cfg.activation in ("swiglu", "gelu_glu", "relu_glu")
    wi = ParamDef((D, 2, F)) if glu else ParamDef((D, F))
    return {"wi": wi, "wo": ParamDef((F, D))}


def model_def(cfg: ModelConfig) -> Dict:
    _check_family(cfg)
    D, V, L = cfg.d_model, cfg.vocab_padded, cfg.n_layers
    out: Dict = {"embed": ParamDef((V, D), "normal:0.02"),
                 "final_norm": ParamDef((D,), "ones")}
    if not cfg.tie_embeddings:
        out["head"] = ParamDef((D, V))
    layer = {"ln1": ParamDef((D,), "ones"), "attn": _attn_def(cfg),
             "ln2": ParamDef((D,), "ones"), "mlp": _mlp_def(cfg)}
    out["layers"] = _map(lambda p: p.stacked(L), layer)
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def param_shapes(cfg: ModelConfig) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Tree path -> shape for every parameter leaf."""
    return {path: p.shape for path, p in _leaves(model_def(cfg))}


def param_bytes(cfg: ModelConfig) -> int:
    itemsize = torch.empty((), dtype=torch_dtype(cfg.param_dtype)).element_size()
    return sum(math.prod(s) * itemsize for s in param_shapes(cfg).values())


def n_params(cfg: ModelConfig) -> int:
    return sum(math.prod(s) for s in param_shapes(cfg).values())


def _std(path: Tuple[str, ...], shape: Tuple[int, ...], init: str) -> float:
    """Init scale of one (unstacked) leaf: the fixed std of ``normal:``
    leaves, else 1/sqrt(fan-in) over the dims the projection contracts —
    the first, or (heads, head_dim) for the attention output."""
    if init.startswith("normal:"):
        return float(init.split(":")[1])
    fan_in = shape[0] * shape[1] if path[-2:] == ("attn", "wo") else shape[0]
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
        if p.init == "ones":
            t.fill_(1.0)
        elif path[0] == "layers":
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
