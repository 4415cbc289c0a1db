"""The latency and rate arithmetic: TTFT from the due time, missing
requests at the stop, a stall moving the rate and the tail."""
import math

import tiny  # noqa: F401
from benchkit.record import Req, Run, Snap, percentile, tpot, ttft
from benchkit.spec import load_reader

READ = {n: load_reader(tiny.BENCH, n) for n in
        ("ttft_p90_s", "tpot_p90_s", "output_tokens_per_s",
         "submit_lag_p90_s.chat", "setup_s")}


def req(rid, due, submitted, first, done, n=11, phase="window"):
    return Req(rid, phase, due, submitted, first, done, 100, n,
               n if done is not None else 3, 0)


def snap(t, served):
    return Snap(t, {}, {}, {}, dict(enumerate(served)))


def make_run(reqs, t_stop=100.0, served0=(0, 0), served1=(50, 50),
             t0=10.0, t1=20.0):
    return Run(arch={}, cell={}, workload="w", seconds=t1 - t0, t_start=1.0,
               t_stop=t_stop, open=snap(t0, served0), close=snap(t1, served1),
               reqs=reqs, chunk=16, memory_peak_bytes=0)


def test_ttft_counts_from_due_not_submit():
    r = req(0, due=10.0, submitted=10.5, first=12.0, done=14.0)
    assert ttft(r, 100.0) == 2.0
    assert tpot(r, 100.0) == (14.0 - 12.0) / 10
    run = make_run([r])
    assert READ["ttft_p90_s"](run) == 2.0
    assert READ["submit_lag_p90_s.chat"](run) == 0.5
    assert READ["setup_s"](run) == 9.0


def test_missing_request_counts_at_stop():
    r = req(0, due=10.0, submitted=10.0, first=None, done=None)
    assert ttft(r, 50.0) == 40.0 and tpot(r, 50.0) == math.inf
    r = req(1, due=10.0, submitted=10.0, first=12.0, done=None)
    assert ttft(r, 50.0) == 2.0 and tpot(r, 50.0) == (50.0 - 12.0) / 2


def test_tpot_divides_by_tokens_served():
    """Not by max_new: a request stopped early divides by what it
    served."""
    r = Req(0, "window", 10.0, 10.0, 12.0, 14.0, 100, 50, 5, 0)
    assert tpot(r, 100.0) == (14.0 - 12.0) / 4


def test_percentiles_of_the_window():
    """p90 by nearest rank over 37 requests due in the window: the 34th;
    a missing request's TPOT sits at the tail's far end."""
    rs = [req(i, 10.0, 10.0, 11.0 + i, 21.0 + i) for i in range(37)]
    run = make_run(rs)
    assert READ["ttft_p90_s"](run) == 34.0
    assert READ["tpot_p90_s"](run) == 1.0
    rs[0] = req(0, 10.0, 10.0, None, None)
    assert READ["tpot_p90_s"](make_run(rs)) == 1.0
    assert READ["tpot_p90_s"](make_run(rs[:3])) == math.inf


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert percentile(v, 90) == 90 and percentile(v, 50) == 50
    assert percentile([5.0], 90) == 5.0
    assert math.isnan(percentile([], 90))
    assert percentile(list(range(1, 11)), 90) == 9


def test_a_stall_moves_rate_and_tail():
    steady = [req(i, 10 + i, 10 + i, 10.5 + i, 12 + i) for i in range(10)]
    # a 3 s stall at t = 14: requests due from then get their first token
    # late, the window serves fewer tokens
    stalled = [req(i, 10 + i, 10 + i,
                   10.5 + i + (3.0 if 10 + i >= 14 else 0.0),
                   12 + i + 3.0) for i in range(10)]
    a = make_run(steady)
    b = make_run(stalled, served1=(40, 30))
    assert READ["ttft_p90_s"](a) == 0.5
    assert READ["ttft_p90_s"](b) == 3.5
    assert READ["output_tokens_per_s"](a) == 10.0
    assert READ["output_tokens_per_s"](b) == 7.0


def test_only_window_requests_count():
    rs = [req(0, 5, 5, 30, 31, phase="warm"),
          req(1, 10, 10, 11, 12), req(2, 25, 25, 60, 61, phase="cool")]
    assert READ["ttft_p90_s"](make_run(rs)) == 1.0


def test_judge_each_number_beside_its_limit():
    import numpy as np
    from benchkit import check
    gaps = np.array([0.0] * 95 + [0.01, 0.02, 0.03, 0.5, 2.0])
    d = check.describe(gaps)
    assert d["gap_max"] == 2.0 and d["share_off"] == 0.05
    ok = check.judge(gaps, {"gap_p90": 0.3})
    assert ok["gap_p90"]["value"] == 0.0 and check.passed(ok)
    assert not check.passed(check.judge(gaps, {"gap_max": 1.0}))
    assert not check.passed(check.judge(np.zeros(0), {"gap_p90": 0.3}))
    assert list(ok)[-1] == "tokens_compared"
