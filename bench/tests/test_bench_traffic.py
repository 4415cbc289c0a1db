"""The traffic generator: deterministic for a seed, the same work for
every seed."""
import numpy as np

import tiny  # noqa: F401  (puts bench/ and src/ on the path)
from benchkit import traffic

CELL = {
    "loop": "open", "rate_per_s": 3.0, "warmup_s": 4.0, "drain_s": 6.0,
    "prompt": {"dist": "lognormal", "median": 256, "sigma": 0.7, "min": 32,
               "max": 1024},
    "output": {"dist": "lognormal", "median": 160, "sigma": 0.7, "min": 16,
               "max": 512},
    "shared_prefix": {"count": 8, "tokens": 64, "zipf_s": 1.0},
    "clients": 8, "first_output": {"dist": "uniform", "min": 16, "max": 64},
}
BIG = 2 ** 31 + 12345          # seeds above 32 signed bits


def items(seed, seconds=10.0):
    return traffic.Traffic(CELL, seed, 32768).open_items(seconds)


def test_same_seed_same_requests():
    a, b = items(BIG), items(BIG)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.due == y.due and x.max_new == y.max_new
        assert x.phase == y.phase and x.prefix == y.prefix
        assert np.array_equal(x.prompt, y.prompt)


def test_other_seed_same_work_other_order():
    a, b = items(BIG), items(BIG + 1)
    for phase in ("warm", "window", "cool"):
        pa = [x for x in a if x.phase == phase]
        pb = [x for x in b if x.phase == phase]
        assert len(pa) == len(pb) > 0
        assert sorted(len(x.prompt) for x in pa) == \
            sorted(len(x.prompt) for x in pb)
        assert sorted(x.max_new for x in pa) == sorted(x.max_new for x in pb)
    assert [len(x.prompt) for x in a] != [len(x.prompt) for x in b]
    assert not np.array_equal(a[0].prompt[:64], b[0].prompt[:64])


def test_phases_rates_and_prefixes():
    a = items(7, seconds=10.0)
    window = [x for x in a if x.phase == "window"]
    assert len(window) == 30 and all(0 <= x.due < 10.0 for x in window)
    assert all(-4.0 <= x.due < 0 for x in a if x.phase == "warm")
    assert all(10.0 <= x.due < 16.0 for x in a if x.phase == "cool")
    assert [x.due for x in a] == sorted(x.due for x in a)
    t = traffic.Traffic(CELL, 7, 32768)
    w = t._phase(30, 0.0, 10.0, "window", 3)
    counts = np.bincount([x.prefix for x in w], minlength=8)
    assert list(counts) == list(traffic.zipf_counts(30, 8, 1.0))
    assert counts[0] > counts[7]
    for x in w:
        assert np.array_equal(x.prompt[:64], t.prefixes[x.prefix])
        assert 32 <= len(x.prompt) - 64 <= 1024


def test_closed_loop_stream():
    t1, t2 = (traffic.Traffic(CELL, BIG, 32768) for _ in range(2))
    first = t1.first_wave()
    assert len(first) == 8 and all(16 <= x.max_new <= 64 for x in first)
    s1 = [t1.next_closed() for _ in range(300)]
    t2.first_wave()
    s2 = [t2.next_closed() for _ in range(300)]
    assert [x.max_new for x in s1] == [x.max_new for x in s2]
    assert sorted(x.max_new for x in s1[:256]) == \
        list(traffic.quantiles(CELL["output"], 256))


def test_quantiles():
    q = traffic.quantiles({"dist": "uniform", "min": 128, "max": 512}, 385)
    assert list(q) == list(range(128, 513))
    ln = traffic.quantiles({"dist": "lognormal", "median": 48, "sigma": 0.8,
                            "min": 8, "max": 256}, 101)
    assert ln[50] == 48 and ln.min() >= 8 and ln.max() <= 256
