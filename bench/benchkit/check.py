"""The comparison that decides ``correct``: the served tokens of a sample
of finished requests against the plain reference.

The reference (``bench/reference/<family>.py``) runs once over each
sampled prompt followed by its served tokens, in float32 from the same
bf16 weights, and gives the logits at every position that produced a
served token.  A served token's gap is how far its reference logit lies
below the reference's best logit at that position.  Greedy decoding that
follows the model serves gaps of rounding size only (near-ties that the
bf16 path breaks the other way); a wrong cache, a wrong expert or an
altered token serves gaps of the logits' own scale.

A cell's file names the numbers it compares (``check.limits``): the
widest gap where it separates the program from the control, and a
percentile and the mean of the gaps where a model's own rounding reaches
the widest gap (an expert layer's top-2 routing flips between near-equal
experts under bf16 rounding, and a flipped token's logits move by a good
part of their scale).

The sample is drawn from the seed, by request: the longest finished
request (most positions) with every served token, then up to
``SAMPLE_REQUESTS - 1`` others at random, each with its first
``SAMPLE_CAP`` served tokens, so that a fault in any one batch row or
slot meets the sample in some of its requests.

The control (``control_gaps``) puts the reference computed in float8 in
the program's place: at each position of the same sequences, the gap of
the token that the float8 logits put first.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Sequence

import numpy as np

from benchkit.traffic import rng_for


SAMPLE_REQUESTS = 12     # finished requests a run compares
SAMPLE_CAP = 64          # served tokens compared of each but the longest


@dataclasses.dataclass
class Part:
    """What the reference judges of one finished request: its prompt and
    the served tokens compared."""
    prompt: np.ndarray
    generated: List[int]


def sample(done: Sequence, seed: int) -> List[Part]:
    """Finished requests to compare: the one with the most positions with
    all its served tokens, then a seeded draw of the rest, each with its
    first ``SAMPLE_CAP`` served tokens."""
    if not done:
        return []
    order = sorted(done, key=lambda r: (-(len(r.prompt) + len(r.generated)),
                                        r.rid))
    first, rest = order[0], order[1:]
    rng = rng_for(seed, 7)
    picked = [rest[i] for i in
              rng.permutation(len(rest))[:SAMPLE_REQUESTS - 1]]
    return [Part(first.prompt, list(first.generated))] + \
        [Part(r.prompt, list(r.generated[:SAMPLE_CAP])) for r in picked]


def reference_logits(torch, params, arch: Dict, reqs, prec: str = "fp32"):
    """The reference's float32 logits (n_served, V) of each request, at
    the positions that produced its served tokens."""
    fam = importlib.import_module(f"reference.{arch['reference']['family']}")
    dev = params["embed"].device
    seqs, rows = [], []
    for r in reqs:
        S, g = len(r.prompt), len(r.generated)
        seq = np.concatenate([r.prompt, np.asarray(r.generated[:-1],
                                                   np.int32)])
        seqs.append(torch.from_numpy(seq.astype(np.int64)).to(dev))
        rows.append(torch.arange(S - 1, S - 1 + g, device=dev))
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 means float32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return fam.logits(params, arch, seqs, rows, prec)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def served_gaps(torch, ref: List, reqs) -> np.ndarray:
    """Each served token's gap below the reference's best logit."""
    out = []
    for lg, r in zip(ref, reqs):
        tok = torch.as_tensor(np.asarray(r.generated, np.int64),
                              device=lg.device)
        best = lg.max(dim=-1).values
        out.append((best - lg.gather(1, tok[:, None])[:, 0]).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def compare(torch, params, arch: Dict, reqs) -> np.ndarray:
    """The gap of every served token of the sample."""
    return served_gaps(torch, reference_logits(torch, params, arch, reqs),
                       reqs)


def describe(gaps: np.ndarray) -> Dict[str, float]:
    """The numbers a cell may compare, of a sample's gaps: the widest,
    the 99th and 90th percentiles (numpy's linear interpolation), the
    mean, and the share of tokens with any gap (where the reference's
    best is another token)."""
    if not gaps.size:
        return {}
    return {"gap_max": float(gaps.max()),
            "gap_p99": float(np.quantile(gaps, 0.99)),
            "gap_p90": float(np.quantile(gaps, 0.90)),
            "gap_mean": float(gaps.mean()),
            "share_off": float((gaps > 0).mean())}


def judge(gaps: np.ndarray, limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number the cell compares beside its limit, and the tokens
    compared beside the least that counts."""
    d = describe(gaps)
    out = {name: {"value": d.get(name, float("inf")), "limit": lim}
           for name, lim in limits.items()}
    out["tokens_compared"] = {"value": int(gaps.size), "min": 1}
    return out


def passed(checks: Dict[str, Dict]) -> bool:
    return all(c["value"] <= c["limit"] if "limit" in c
               else c["value"] >= c["min"] for c in checks.values())


def control_gaps(torch, params, arch: Dict, reqs) -> Dict[str, np.ndarray]:
    """The gaps, at the same positions, of the program's served tokens,
    of the tokens the float8 control puts first, and of those the
    reference rounded to bf16 at every product puts first (a witness of
    what bf16 arithmetic alone gives)."""
    ref = reference_logits(torch, params, arch, reqs)
    out = {"program": served_gaps(torch, ref, reqs)}
    for name, prec in (("control", "fp8"), ("witness_bf16", "bf16")):
        low = reference_logits(torch, params, arch, reqs, prec=prec)
        g = []
        for lg, lo in zip(ref, low):
            top = lo.argmax(dim=-1)
            g.append((lg.max(dim=-1).values
                      - lg.gather(1, top[:, None])[:, 0]).cpu().numpy())
        out[name] = np.concatenate(g)
    return out
