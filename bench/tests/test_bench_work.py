"""The yardstick's arithmetic: the frozen ring_work against hand counts,
the needed FLOPs of both configurations, the decode-step bounds."""
import json

import pytest
import torch

import tiny
from benchkit import work

ARCH = {n: json.loads((tiny.BENCH / "configs" / f"{n}.json").read_text())
        for n in ("starcoder2-15b", "mixtral-8x22b-l8")}
SMALL = {"num_attention_heads": 2, "num_key_value_heads": 1,
         "hidden_size": 4, "reference": {"window": 0}}


def ring_inputs(n_tokens):
    B, C, W, Hq, Hkv, dh = 1, 4, 8, 2, 1, 2
    bf = torch.bfloat16
    q = torch.zeros(B, C, Hq, dh, dtype=bf)
    kn = torch.zeros(B, C, Hkv, dh, dtype=bf)
    kc = torch.zeros(B, W, Hkv, dh, dtype=bf)
    pos = torch.tensor([3], dtype=torch.int32)
    n = torch.tensor([n_tokens], dtype=torch.int32)
    # ring slots 0-2 hold positions 0-2; chunk token t is position 3 + t
    mask = torch.zeros(B, C, W + C, dtype=torch.bool)
    for t in range(C):
        mask[0, t, :3] = True
        mask[0, t, W:W + t + 1] = True
    return (q, kn, kn, kc, kc, pos, n), mask


def test_ring_work_hand_count():
    ins, mask = ring_inputs(2)
    # rows 0 and 1 active: 4 and 5 visible keys; 5 distinct slots seen
    n_bytes, flops = work.ring_work(torch, ins, mask)
    assert n_bytes == 2 * (4 * 2 * 2) * 2 + 2 * 5 * 1 * 2 * 2 + 4 + 4
    assert flops == 4 * 2 * 2 * (4 + 5)


def test_chunk_ring_work_equals_ring_work_of_a_full_row():
    ins, mask = ring_inputs(4)
    assert work.chunk_ring_work(SMALL, 3, 4) == \
        tuple(float(x) for x in work.ring_work(torch, ins, mask))
    assert work.chunk_ring_work(SMALL, 3, 4) == (128.0, 4 * 2 * 2 * 22.0)


def test_chunk_ring_work_window():
    win = dict(SMALL, reference={"window": 4})
    # p 10, n 2: row 0 (pos 10) sees 7-10, row 1 sees 8-11: 5 keys, 8 pairs
    nb, nf = work.chunk_ring_work(win, 10, 2)
    assert nf == 4 * 2 * 2 * 8
    assert nb == 2 * 2 * 2 * 2 * 2 + 2 * 5 * 1 * 2 * 2 + 8


def test_prefill_chunks():
    assert list(work.prefill_chunks(32, 0, 100, 90, 16)) == \
        [(32, 16), (48, 16), (64, 16), (80, 10)]
    assert list(work.prefill_chunks(32, 48, 80, 90, 16)) == \
        [(48, 16), (64, 16)]
    assert list(work.prefill_chunks(0, 0, 5, 90, 16)) == [(0, 16)]
    assert list(work.prefill_chunks(0, 90, 120, 90, 16)) == []


def test_needed_flops_starcoder2():
    a = ARCH["starcoder2-15b"]
    attn = 2 * 6144 * 48 * 128 + 2 * 6144 * 4 * 128
    mlp = 2 * 6144 * 24576
    assert work.attn_params(a) == attn == 81_788_928
    assert work.ffn_params(a) == mlp
    per_token = 2.0 * 40 * (attn + mlp)
    assert work.token_flops(0, a, False) == per_token + 4 * 128 * 48 * 40
    assert work.token_flops(99, a, True) == \
        per_token + 4 * 128 * 48 * 40 * 100 + 2 * 6144 * 49152
    assert work.span_flops(a, 100, 0, 130) == pytest.approx(
        sum(work.token_flops(j, a, j >= 99) for j in range(130)), rel=1e-12)


def test_needed_flops_mixtral_counts_two_experts():
    a = ARCH["mixtral-8x22b-l8"]
    attn = 2 * 6144 * 48 * 128 + 2 * 6144 * 8 * 128
    experts = 2 * 3 * 6144 * 16384 + 6144 * 8
    assert work.ffn_params(a) == experts
    assert work.ffn_params(a, held=True) == 8 * 3 * 6144 * 16384 + 6144 * 8
    assert work.token_flops(0, a, False) == \
        2.0 * 8 * (attn + experts) + 4 * 128 * 48 * 8
    # the window (4096) caps the keys a late position attends
    assert work.attended_keys(5000, a) == 4096
    assert work.span_flops(a, 10, 4090, 4100) == pytest.approx(
        sum(work.token_flops(j, a, True) for j in range(4090, 4100)),
        rel=1e-12)


def test_weight_bytes_and_bounds_match_the_port():
    from benchkit.serve import port_config
    from repro_torch.models.params import param_bytes
    for name, a in ARCH.items():
        assert work.param_bytes(a) == param_bytes(port_config(a)), name
    assert work.decode_bound_s(ARCH["starcoder2-15b"]) == pytest.approx(
        9.35e-3, rel=1e-3)
    assert work.decode_bound_s(ARCH["mixtral-8x22b-l8"]) == pytest.approx(
        12.08e-3, rel=1e-3)


def test_weights_layout_is_the_ports():
    from benchkit import weights
    from benchkit.serve import port_config
    from repro_torch.models.params import param_shapes
    for a in ARCH.values():
        mine = {p: s for p, (s, _) in weights.shapes(a).items()}
        assert mine == dict(param_shapes(port_config(a)))


def test_window_flops_from_snapshots():
    from benchkit.record import Req, Snap
    a = ARCH["starcoder2-15b"]
    r = Req(7, "window", 0.0, 0.0, 1.0, None, 100, 20, 5, 32)
    s0 = Snap(0.0, {}, {}, {7: 0}, {})
    s1 = Snap(1.0, {}, {}, {7: 64}, {})
    s2 = Snap(2.0, {}, {}, {7: 104}, {})
    # the shared prefix's 32 positions were not computed
    assert work.window_flops(a, [r], s0, s1) == \
        work.span_flops(a, 100, 32, 64)
    assert work.window_flops(a, [r], s1, s2) == \
        work.span_flops(a, 100, 64, 104)
    nb, nf = work.window_ring(a, [r], s1, s2, 16)
    chunks = [(64, 16), (80, 16), (96, 4)]
    assert nf == sum(work.chunk_ring_work(a, p, n)[1] for p, n in chunks) \
        * 40
