"""Random bf16 weights from the seed, made on the device by the benchmark
and handed to both sides: the program (``ServeEngine(params=...)``) and
the plain reference.

The tree is the layout the port's engine takes (``models/params.py``): a
nested dict whose layer leaves are stacked on a leading layer axis.  Each
leaf is one ``normal_`` call of a ``torch.Generator`` on the device, at
the port's initialiser scales (1/sqrt(fan-in); 0.02 for the embedding;
norms at one), so the model is as well-conditioned as the program's own
tests make it.
"""
from __future__ import annotations

from typing import Dict, Tuple

from benchkit import work


def shapes(arch: Dict) -> Dict[Tuple[str, ...], Tuple[Tuple[int, ...], float]]:
    """Tree path -> (shape, init std; 0 for a norm's ones)."""
    D, F = arch["hidden_size"], arch["intermediate_size"]
    Hq, Hkv, dh = (arch["num_attention_heads"], arch["num_key_value_heads"],
                   work.head_dim(arch))
    L, V = arch["num_hidden_layers"], work.padded_vocab(arch["vocab_size"])
    E = arch.get("num_local_experts", 0)
    glu = arch["reference"]["activation"] == "swiglu"
    out = {("embed",): ((V, D), 0.02), ("final_norm",): ((D,), 0.0),
           ("head",): ((D, V), D ** -0.5)}
    lay = {("ln1",): ((D,), 0.0), ("ln2",): ((D,), 0.0),
           ("attn", "wq"): ((D, Hq, dh), D ** -0.5),
           ("attn", "wk"): ((D, Hkv, dh), D ** -0.5),
           ("attn", "wv"): ((D, Hkv, dh), D ** -0.5),
           ("attn", "wo"): ((Hq, dh, D), (Hq * dh) ** -0.5)}
    wi = (D, 2, F) if glu else (D, F)
    if E:
        lay[("moe", "router")] = ((D, E), D ** -0.5)
        lay[("moe", "wi")] = ((E,) + wi, D ** -0.5)
        lay[("moe", "wo")] = ((E, F, D), F ** -0.5)
    else:
        lay[("mlp", "wi")] = (wi, D ** -0.5)
        lay[("mlp", "wo")] = ((F, D), F ** -0.5)
    for path, (shape, std) in lay.items():
        out[("layers",) + path] = ((L,) + shape, std)
    return out


def make(torch, arch: Dict, seed: int, device) -> Dict:
    """The weight tree in bf16 on ``device``, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: Dict = {}
    for path, (shape, std) in shapes(arch).items():
        t = torch.empty(shape, dtype=torch.bfloat16, device=device)
        if std:
            t.normal_(0.0, std, generator=gen)
        else:
            t.fill_(1.0)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree
