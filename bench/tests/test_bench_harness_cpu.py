"""The harness end to end on the CPU at a tiny size: a configuration, a
cell and a per-layer metric added as new files are found and run, no
file already there edited; a sound run is correct, and a run with the
timed path broken underneath is not."""
import hashlib

import pytest

import tiny

READER = '''"""served_requests.tiny: requests that served every token."""
LAYER = "engine loop"
UNIT = "requests"
SOURCE = "program_counter"
MOVES = "ttft_p90_s"


def read(run):
    return float(sum(r.t_done is not None for r in run.reqs))
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "bench").rglob("*") if p.is_file()}


def test_new_files_only_are_found_and_run(tmp_path):
    root = tiny.make_root(tmp_path, extra_metric="served_requests.tiny")
    before = digests(root)
    (root / "bench/metrics/served_requests.tiny.py").write_text(READER)
    out = tiny.run(root, trace=True)
    assert out["metrics"]["served_requests.tiny"]["value"] > 0
    assert {"submit_lag_p90_s.chat", "graph_step_share.chat"} <= \
        set(out["metrics"])
    assert out["correct"] and out["failed"] == 0
    after = digests(root)
    assert {p: d for p, d in after.items() if p in before} == before
    e2e = tiny.run(root)
    assert set(e2e["metrics"]) == {"ttft_p90_s", "tpot_p90_s", "setup_s"}
    assert list(e2e)[-1] == "checks"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("faults"))


def test_sound_run_is_correct(root):
    out = tiny.run(root, seed=5)
    for name in ("gap_max", "gap_p90"):
        c = out["checks"][name]
        assert c["value"] <= c["limit"]
    assert out["correct"]
    assert out["checks"]["tokens_compared"]["value"] >= 30


def test_sample_takes_the_longest_whole_and_caps_the_rest():
    """By request: the longest with every served token, then a seeded
    draw of others, each with its first SAMPLE_CAP served tokens."""
    import types

    import numpy as np
    from benchkit import check
    done = [types.SimpleNamespace(rid=i, prompt=np.zeros(10 + i, np.int32),
                                  generated=list(range(100 + i)))
            for i in range(40)]
    parts = check.sample(done, 77)
    assert len(parts) == check.SAMPLE_REQUESTS
    assert len(parts[0].prompt) == 49 and len(parts[0].generated) == 139
    assert all(len(p.generated) == check.SAMPLE_CAP for p in parts[1:])
    again = check.sample(done, 77)
    assert [len(p.prompt) for p in again] == [len(p.prompt) for p in parts]
    other = check.sample(done, 78)
    assert [len(p.prompt) for p in other] != [len(p.prompt) for p in parts]
    assert len(check.sample(done[:3], 77)) == 3


def test_fault_in_one_batch_row_is_not_correct(root, monkeypatch):
    """A token altered in one row of the batch only: the requests that
    pass through that row are served wrong, the others right."""
    from repro_torch.models import decode as dec
    pick = dec.next_token_ids

    def one_row(logits, n_tokens):
        t = pick(logits, n_tokens)
        if t.numel() > 1:
            t = t.clone()
            t[1] = t[1].where(t[1] < 0, (t[1] + 7) % 512)
        return t
    monkeypatch.setattr(dec, "next_token_ids", one_row)
    out = tiny.run(root, seed=5)
    assert not out["correct"]


def test_altered_token_is_not_correct(root, monkeypatch):
    """A token altered where it is produced (the greedy pick)."""
    from repro_torch.models import decode as dec
    pick = dec.next_token_ids

    def altered(logits, n_tokens):
        t = pick(logits, n_tokens)
        return t.where(t < 0, (t + 7) % 512)
    monkeypatch.setattr(dec, "next_token_ids", altered)
    out = tiny.run(root, seed=5)
    assert not out["correct"]


def test_step_that_returns_its_state_unchanged_is_not_correct(root,
                                                              monkeypatch):
    """A paged step whose cache writes are lost: the pool keeps its state."""
    from repro_torch.models import decode as dec
    monkeypatch.setattr(dec, "scatter_cache_view",
                        lambda pool, spec, tables, slots, view: None)
    out = tiny.run(root, seed=5)
    assert not out["correct"]


def test_float8_control_fails_where_the_program_passes(root):
    """The control at a size a test run holds: the reference in float8
    in the program's place fails one of the cell's numbers; the program
    and the bf16 witness pass them."""
    import control
    r = control.readings(tiny.NAME, 5, 1.5, root=root, device="cpu")
    limits = tiny.CELL["check"]["limits"]
    assert all(r["program"][n] <= lim for n, lim in limits.items()), r
    assert any(r["control"][n] > lim for n, lim in limits.items()), r
    assert r["witness_bf16"]["gap_max"] < r["control"]["gap_max"], r


def test_closed_loop_cell_traced(tmp_path):
    """A closed-loop cell (clients, no arrivals schedule) runs traced and
    reports its per-layer metrics."""
    import json
    root = tiny.make_root(tmp_path)
    cell = dict(tiny.CELL, loop="closed", clients=4, traffic="batch",
                warmup_s=1.0,
                prompt={"dist": "uniform", "min": 8, "max": 16},
                output={"dist": "uniform", "min": 2, "max": 4},
                first_output={"dist": "uniform", "min": 2, "max": 4})
    (root / "bench/cells/tiny-dense.batch.json").write_text(json.dumps(cell))
    bm = json.loads((root / "BENCHMARK.json").read_text())
    bm["workloads"].append({"name": "tiny-dense.batch", "config": "tiny-dense",
                            "traffic": "batch", "chips": 1, "why": "test"})
    for m in bm["end_to_end"] + bm["per_layer"]:
        if m["name"].endswith(".batch") or m["name"] == "output_tokens_per_s":
            m["workloads"].append("tiny-dense.batch")
    (root / "BENCHMARK.json").write_text(json.dumps(bm))
    import time
    from benchkit import harness
    out = harness.run(root, "tiny-dense.batch", 11, 2.0, True,
                      time.monotonic(), device="cpu")
    assert out["correct"]
    assert {"decode_rows_per_step.batch", "graph_step_share.batch",
            "mfu.batch", "device_idle_share.batch"} <= set(out["metrics"])
    e2e = harness.run(root, "tiny-dense.batch", 11, 2.0, False,
                      time.monotonic(), device="cpu")
    assert e2e["metrics"]["output_tokens_per_s"]["value"] > 0
