"""The device trace's reduction: busy seconds as the union of activity
intervals, idle gaps named by the host op under them, the ring kernels
by name, and the readers that use them."""
import pytest

import tiny
from benchkit import trace, work
from benchkit.record import Req, Run, Snap, Trace
from benchkit.spec import load_reader

RING = "(anonymous namespace)::ring_wgmma_kernel<128>(CUtensorMap_st, int)"
MERGE = "(anonymous namespace)::ring_combine_kernel<128>(float const*)"


def make_trace():
    device = [(0.0, 1.0, "gemm"), (0.5, 1.5, RING), (2.0, 2.5, MERGE),
              (2.5, 3.0, "gemm")]
    host = [(0.0, 4.0, "step"), (1.6, 1.9, "cudaMemcpyAsync"),
            (3.0, 4.0, "cudaGraphLaunch")]
    s = Snap(0.0, {}, {}, {}, {})
    return Trace(device, host, 5.0, s, s)


def test_busy_is_the_union():
    tr = make_trace()
    assert trace.busy_s(tr) == pytest.approx(1.5 + 1.0)
    assert trace.ring_seconds(tr) == pytest.approx(1.0 + 0.5)


def test_breakdown_names_gaps_by_innermost_host_op():
    b = trace.breakdown(make_trace())
    assert b["device_ops"][0] == ["gemm", 1.5]
    idle = dict(b["idle_gaps"])
    assert idle["cudaMemcpyAsync"] == pytest.approx(0.5)
    assert idle["cudaGraphLaunch"] == pytest.approx(1.0)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_readers_of_the_trace():
    arch = {"num_hidden_layers": 1, "hidden_size": 4,
            "num_attention_heads": 2, "num_key_value_heads": 1,
            "intermediate_size": 8, "vocab_size": 16,
            "reference": {"activation": "gelu_tanh", "window": 0}}
    tr = make_trace()
    tr.start = Snap(0.0, {}, {}, {1: 0}, {})
    tr.stop = Snap(5.0, {}, {}, {1: 32}, {})
    r = Req(1, "window", 0.0, 0.0, None, None, 40, 4, 0, 0)
    run = Run(arch=arch, cell={}, workload="w", seconds=5.0, t_start=0.0,
              t_stop=5.0, open=tr.start, close=tr.stop, reqs=[r], chunk=16,
              memory_peak_bytes=0, trace=tr)
    idle = load_reader(tiny.BENCH, "device_idle_share.chat")(run)
    assert idle == pytest.approx(100.0 * (1 - 2.5 / 5.0))
    nb, nf = work.window_ring(arch, [r], tr.start, tr.stop, 16)
    ring = load_reader(tiny.BENCH, "ring_roofline.chat")(run)
    assert ring == pytest.approx(
        100.0 * max(nb / work.PEAK_BYTES, nf / work.PEAK_FLOPS) / 1.5)
    mfu = load_reader(tiny.BENCH, "mfu_busy.chat")(run)
    assert mfu == pytest.approx(100.0 * work.span_flops(arch, 40, 0, 32)
                                / (2.5 * work.PEAK_FLOPS))
    run.trace = None
    assert load_reader(tiny.BENCH, "ring_roofline.chat")(run) is None
