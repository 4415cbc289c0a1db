"""The port's twins of the training examples against the JAX examples on
the CPU: ``quickstart_torch.py``, ``elastic_restart_torch.py`` and
``train_e2e_torch.py`` beside ``quickstart.py``, ``elastic_restart.py`` and
``train_e2e.py``.

Each JAX example runs unchanged (its ``main()``, stdout captured) with its
``Trainer`` name wrapped so that the test sees the weights it started from
and what each ``run()`` returned; its files go under the test's tmp dir.
The twin starts from those weights (``from_reference``) and must print the
same lines — a step's milliseconds and the tokens a second are readings of
the clock, present but not compared — and give the same losses within
1e-4.

train_e2e runs cut: 3 steps at B 2, S 32 (the JAX example's flags
``--steps 3 --seq 32 --batch 2``; its 300 steps at B 8, S 256 are the
card's, ``chip_smoke.py`` phase 17), ``model_100m()`` at its full width
and depth.  At 3 steps the example's own assert (the mean loss of the
last 10 steps below the first 10's) compares a set of steps with itself
and fails, in both examples alike."""
import contextlib
import dataclasses
import io
import shutil
import sys
import types

import jax
import numpy as np
import pytest
import torch

from torch_example_twins import (LossSpy, load_example, one_ulp_apart,
                                 recording, same_lines)
from repro_torch.models.params import from_reference, tree_map
from repro_torch.runtime.trainer import Trainer as TTrainer

TRAINER_MS = r"\((\d+) ms\)"


def redirect(mod, old, new):
    """Point the JAX example's hard-coded ``old`` directory at ``new``:
    its ``shutil.rmtree``, its corpus shards and its Trainer's
    checkpoints (the module's names; the file is not touched)."""
    move = lambda p: str(p).replace(old, str(new))
    rmtree, write = mod.shutil.rmtree, mod.write_corpus_shards
    mod.shutil = types.SimpleNamespace(
        rmtree=lambda p, **kw: rmtree(move(p), **kw))
    mod.write_corpus_shards = lambda p, *a, **kw: write(move(p), *a, **kw)

    def init(args, kwargs):
        args = list(args)
        args[3] = dataclasses.replace(args[3], ckpt_dir=move(args[3].ckpt_dir))
        return args, kwargs
    return init


def jax_lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines() if ln]


def test_quickstart_twin_matches_the_jax_example(tmp_path, capsys):
    """20 losses within 1e-4, the 12 generated tokens and the counters
    equal, every line the same."""
    jmod = load_example("quickstart")
    rec = {}
    jmod.Trainer = recording(jmod.Trainer, rec, redirect(
        jmod, "/tmp/repro_quickstart", tmp_path / "jax"))
    jmod.main()
    want = jax_lines(capsys)
    out = load_example("quickstart_torch").main(
        device="cpu", workdir=str(tmp_path / "torch"),
        params=from_reference(rec["params0"], "cpu"))
    capsys.readouterr()
    np.testing.assert_allclose(out["losses"], rec["runs"][0]["losses"],
                               rtol=1e-4, atol=1e-4)
    assert len(out["losses"]) == out["steps"] == 20
    assert f"generated tokens: {out['generated']}" in want
    assert len(out["generated"]) == 12
    assert f"ARCAS counters: {out['counters']}" in want
    same_lines(want, out["lines"], clock=[TRAINER_MS])


def jax_elastic(workdir, nudge=False):
    """The JAX elastic_restart example, unchanged, in ``workdir``: its
    record (``params0``, each run's output) with every step's loss of both
    runs (``losses``), and its printed lines.  ``nudge``: the first run
    starts from its weights moved ``one_ulp_apart``."""
    jmod = load_example("elastic_restart")
    jmod.WORKDIR = str(workdir)
    rec = {"losses": []}

    def after(trainer):
        if nudge and len(rec["made"]) == 1:
            trainer.params = jax.device_put(one_ulp_apart(trainer.params),
                                            trainer.psh)
        trainer._jit_step = LossSpy(trainer._jit_step, rec["losses"])
    jmod.Trainer = recording(jmod.Trainer, rec, after=after)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jmod.main()
    return rec, [ln for ln in out.getvalue().splitlines() if ln]


def test_elastic_restart_twin_matches_the_jax_example(tmp_path, capsys,
                                                      monkeypatch):
    """Fails at step 17 with run 1's 17 losses within 1e-4 of the JAX
    run's, resumes at step 10 with the parameters run 1 saved there bit
    for bit, and gives steps 11-30 the JAX run's losses within 1e-4 beyond
    the JAX example's own spread there: the largest difference between two
    JAX runs whose weights start one unit in the last place apart.

    That spread is the floor of any float32 twin: AdamW's update is about
    the sign of the gradient where the gradient is small, so rounding
    differences flip single updates, and by step 29 the two JAX runs'
    losses differ by 8.7e-04 (the port's by 7.9e-04)."""
    rec, want = jax_elastic(tmp_path / "jax")
    nudged, _ = jax_elastic(tmp_path / "jax_nudged", nudge=True)
    twin = load_example("elastic_restart_torch")
    seen = {"losses": []}

    class Spy(TTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._step_fn = LossSpy(self._step_fn, seen["losses"])
            save = self.ckpt.save

            def spy(step, tree, **kw):
                if step == 10:
                    seen.setdefault("saved@10", tree_map(torch.clone,
                                                         tree["params"]))
                return save(step, tree, **kw)
            self.ckpt.save = spy

        def resume_if_possible(self):
            ok = super().resume_if_possible()
            seen["resumed"] = (self.step, tree_map(torch.clone, self.params))
            return ok

    monkeypatch.setattr(twin, "Trainer", Spy)
    out = twin.main(device="cpu", workdir=str(tmp_path / "torch"),
                    params=from_reference(rec["params0"], "cpu"))
    capsys.readouterr()
    assert out["failure"] == "injected failure: host 0 died at step 17"
    assert out["resumed_at"] == seen["resumed"][0] == 10
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             seen["resumed"][1], seen["saved@10"])
    assert len(seen["losses"]) == len(rec["losses"]) == 17 + 20
    np.testing.assert_allclose(seen["losses"][:17], rec["losses"][:17],
                               rtol=1e-4, atol=1e-4)
    assert out["losses"] == seen["losses"][17:]
    jax_after = np.array(rec["runs"][0]["losses"])
    spread = np.abs(np.array(nudged["runs"][0]["losses"]) - jax_after).max()
    np.testing.assert_allclose(out["losses"], jax_after, rtol=1e-4,
                               atol=1e-4 + spread)
    assert len(out["losses"]) == 20 and out["steps"] == 30
    same_lines(want, out["lines"], clock=[TRAINER_MS], rtol=1e-4 + spread)


def test_train_e2e_twin_matches_the_jax_example(tmp_path, capsys,
                                                monkeypatch):
    """``model_100m()`` field by field; then both examples at the cut of
    the module docstring, from the JAX Trainer's weights: the losses
    within 1e-4, every line the same (tokens a second from the clock), and
    the example's loss assert failing in both (3 steps are both the first
    and the last 10)."""
    jmod = load_example("train_e2e")
    twin = load_example("train_e2e_torch")
    assert dataclasses.asdict(twin.model_100m()) == \
        dataclasses.asdict(jmod.model_100m())
    flags = ["--steps", "3", "--seq", "32", "--batch", "2"]
    rec, seen = {}, {}
    jmod.Trainer = recording(jmod.Trainer, rec)

    class Spy(TTrainer):
        def run(self, *args, **kwargs):
            seen["out"] = super().run(*args, **kwargs)
            return seen["out"]

    monkeypatch.setattr(twin, "Trainer", Spy)
    monkeypatch.setattr(sys, "argv", ["train_e2e.py", *flags, "--workdir",
                                      str(tmp_path / "jax")])
    must_fall = pytest.raises(AssertionError, match="loss must decrease")
    try:
        with must_fall:
            jmod.main()
        want = jax_lines(capsys)
        # the checkpoint of 126M parameters and their moments: 1.5 GB
        shutil.rmtree(tmp_path / "jax")
        with must_fall:
            twin.main(flags, device="cpu", workdir=str(tmp_path / "torch"),
                      params=from_reference(rec.pop("params0"), "cpu"))
        got = jax_lines(capsys)
    finally:
        shutil.rmtree(tmp_path / "jax", ignore_errors=True)
        shutil.rmtree(tmp_path / "torch", ignore_errors=True)
    out = seen["out"]
    np.testing.assert_allclose(out["losses"], rec["runs"][0]["losses"],
                               rtol=1e-4, atol=1e-4)
    assert out["steps"] == len(out["step_times"]) == 3
    same_lines(want, got, clock=[TRAINER_MS, r"\((\d+) tok/s"])


@pytest.mark.parametrize("name", ["quickstart", "elastic_restart",
                                  "train_e2e", "serve_adaptive"])
def test_twin_has_the_jax_example_main(name):
    """Each twin keeps the JAX example's entry point and adds the
    keyword-only overrides its tests and ``chip_smoke.py`` use."""
    import inspect
    params = inspect.signature(load_example(f"{name}_torch").main).parameters
    assert list(params)[0] == "argv" and params["argv"].default is None
    assert params["device"].default == "cuda"
    assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY
