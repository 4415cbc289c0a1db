"""The port's twin of the serving example against the JAX example on the
CPU: ``serve_adaptive_torch.py`` beside ``serve_adaptive.py``.

The JAX example runs unchanged (its ``main()``, stdout captured) with its
``ServeEngine`` name wrapped so that the test sees the engine and the
weights it drew; the twin serves from those weights (``from_reference``).
Every request's tokens, the controller's decisions, each relayout, the
count fields of ``kv_stats()`` and the printed counters must be equal,
and every line the same.  A latency (TTFT, TPOT, end to end) is a reading
of the clock: present, not compared.  The controller's decision reads no
clock: the engine's controller runs in step mode (``ControllerConfig.
step_mode``), so its rate (``rate 1.54e+03 >= 4: spread``) is the bytes
its steals moved over an interval of engine steps, compared exactly.

The swap tier's ``pinned_host`` is no count but a property of the
platform: the port pins its host buffers for a cache on the card (a CPU
tensor has nothing to pin for), the JAX package whenever its device
exposes a ``pinned_host`` memory space, as JAX's CPU backend does.  Here
it must be False in the port; every other field is compared."""
import ast
import contextlib
import io
import re

import pytest

from torch_example_twins import load_example, recording, same_lines
from repro_torch.models.params import from_reference

LATENCY = ("ttft", "tpot", "latency")
CLOCK = [rf"'{k}_[a-z0-9]+': (-?[\d.]+(?:e[+-]?\d+)?)" for k in LATENCY]


def counts(stats):
    """A latency summary (``ServeEngine.stats`` or a ``per_class`` entry)
    with the clock's readings replaced by their presence; an SLO verdict
    follows from them."""
    return {k: (True if k.startswith(LATENCY) or k.endswith("_slo_met")
                else v) for k, v in stats.items()}


@pytest.fixture(scope="module")
def runs():
    jmod = load_example("serve_adaptive")
    rec = {}
    jmod.ServeEngine = recording(jmod.ServeEngine, rec)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jmod.main()
    want = [ln for ln in out.getvalue().splitlines() if ln]
    got = load_example("serve_adaptive_torch").main(
        device="cpu", params=from_reference(rec["params0"], "cpu"))
    return rec["made"][0], want, got


def test_every_request_gets_the_jax_tokens(runs):
    jeng, _, got = runs
    assert got["generated"] == [list(r.generated) for r in jeng.submitted]
    assert len(got["generated"]) == 16
    assert all(r.done for r in got["engine"].submitted)
    got["engine"].pool.audit([])


def test_decisions_and_relayouts_are_the_jax_ones(runs):
    jeng, _, got = runs
    assert got["decisions"] == [
        (d.step, d.old_spread, "->", d.new_spread, d.reason)
        for d in jeng.controller.decisions]
    assert got["decisions"], "the long phase must spread the layout"
    keys = ("step", "old_groups", "new_groups", "moved_slots", "requeued",
            "blocks_migrated")
    assert [{k: r[k] for k in keys} for r in got["relayouts"]] == \
        [{k: r[k] for k in keys} for r in jeng.relayouts]


def test_kv_stats_and_counters_are_the_jax_ones(runs):
    jeng, want, got = runs
    jkv, tkv = jeng.kv_stats(), got["engine"].kv_stats()
    assert list(tkv) == list(jkv)
    jpc, tpc = jkv.pop("per_class"), tkv.pop("per_class")
    assert tkv["swap_tier"].pop("pinned_host") is False
    jkv["swap_tier"].pop("pinned_host")
    assert tkv == jkv
    assert {c: counts(s) for c, s in tpc.items()} == \
        {c: counts(s) for c, s in jpc.items()}
    line = next(ln for ln in want if ln.startswith("counters: "))
    assert got["counters"] == ast.literal_eval(line[len("counters: "):])
    for phase, key in (("phase1 (short): ", "short"),
                       ("phase2 (long, open-loop): ", "long")):
        line = next(ln for ln in want if ln.startswith(phase))
        assert counts(got[key]) == counts(ast.literal_eval(
            line[len(phase):]))


def platform_blind(line):
    """A kv pool line with ``pinned_host`` left out and its per-class
    targets (printed as inf) as numbers."""
    line = re.sub(r"'pinned_host': (True|False), ", "", line)
    return re.sub(r"\binf\b", "0", line)


def test_lines_are_the_jax_lines(runs):
    _, want, got = runs
    same_lines([platform_blind(ln) for ln in want],
               [platform_blind(ln) for ln in got["lines"]],
               clock=CLOCK, rtol=0.0)
