"""Helpers of the example parity tests (``test_torch_examples_*.py``): load
an example by path, record what the JAX example's ``Trainer`` or
``ServeEngine`` started from and returned, and compare printed lines with
the clock's numbers left out."""
import importlib.util
import re
from pathlib import Path

import jax
import numpy as np

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NUM = re.compile(r"-?\d+(?:\.(\d+))?(?:e[+-]?\d+)?")


def load_example(name):
    """``examples/<name>.py`` as a fresh module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recording(base, record, init=None, after=None):
    """A subclass of the JAX ``base`` (``Trainer`` or ``ServeEngine``)
    that records its first instance's initial weights (``params0``, as
    numpy), every instance (``made``) and every ``run()`` output
    (``runs``).  ``init(args, kwargs)`` may rewrite the constructor's
    arguments first, ``after(instance)`` act on it once built and
    recorded."""

    class Recording(base):
        def __init__(self, *args, **kwargs):
            if init is not None:
                args, kwargs = init(args, kwargs)
            super().__init__(*args, **kwargs)
            record.setdefault("params0", jax.tree.map(np.array, self.params))
            record.setdefault("made", []).append(self)
            if after is not None:
                after(self)

        def run(self, *args, **kwargs):
            out = super().run(*args, **kwargs)
            record.setdefault("runs", []).append(out)
            return out

    return Recording


def same_lines(jax_lines, port_lines, clock=(), rtol=1e-4):
    """Line for line: the same text around the numbers, each number within
    ``rtol`` of the JAX one plus one unit of its printed last digit.  A
    number that matches a pattern of ``clock`` (a regex whose group 1 is
    the number) is a reading of the clock: it must be there, its value is
    not compared."""
    assert len(port_lines) == len(jax_lines), (jax_lines, port_lines)
    for j, t in zip(jax_lines, port_lines):
        for pat in clock:
            j, t = (re.sub(pat, lambda m: m.group(0).replace(m.group(1), "T"),
                           s) for s in (j, t))
        assert NUM.sub("#", t) == NUM.sub("#", j), (j, t)
        for a, b in zip(NUM.finditer(j), NUM.finditer(t)):
            ulp = 10.0 ** -len(a.group(1) or "")
            x, y = float(a.group(0)), float(b.group(0))
            assert abs(x - y) <= rtol * max(1.0, abs(x)) + ulp, (j, t)


class LossSpy:
    """A train step (the JAX Trainer's ``_jit_step``, the port Trainer's
    ``_step_fn``) that appends each step's loss to ``sink``; any other
    attribute is the step's (the JAX Trainer lowers its step once)."""

    def __init__(self, step, sink):
        self.step, self.sink = step, sink

    def __call__(self, *args):
        out = self.step(*args)
        self.sink.append(float(out[2]["loss"]))
        return out

    def __getattr__(self, name):
        return getattr(self.step, name)


def one_ulp_apart(params):
    """Every weight moved by one unit in its last place, up or down at
    random (seeded): the size of the difference two float32
    implementations of the same step make."""
    rng = np.random.default_rng(0)

    def nudge(x):
        x = np.asarray(x)
        way = np.where(rng.random(x.shape) < 0.5, -np.inf, np.inf)
        return np.nextafter(x, way.astype(x.dtype))
    return jax.tree.map(nudge, params)
