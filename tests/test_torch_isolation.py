"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the port's entry points run on CUDA
unless the caller asks for the CPU — with no path that quietly falls back
to the CPU or to the plain attention."""
import importlib.util
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = ROOT / "examples"
TWINS = ("quickstart", "elastic_restart", "train_e2e", "serve_adaptive")
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                       r"|from\s+repro(\.|\s+import\b))", re.M)

PROBE = """
import sys
import repro_torch, repro_torch.serving.engine, repro_torch.launch.steps
import repro_torch.kernels.flash_attention.ops, repro_torch.core
import repro_torch.runtime.trainer, repro_torch.optim.adamw
import repro_torch.data.pipeline, repro_torch.checkpoint.manager
import repro_torch.models.ssd, repro_torch.kernels.ssd_scan.ops
import repro_torch.models.rglru, repro_torch.kernels.rglru_scan.ops
import repro_torch.serving.spec, repro_torch.core.api
import repro_torch.models.transformer, repro_torch.models.decode
import repro_torch.models.layers, repro_torch.models.params
import repro_torch.models.moe, repro_torch.serving.kvpool
import repro_torch.launch.inputs, repro_torch.launch.analysis
import repro_torch.launch.dryrun, repro_torch.launch.trace_analysis
import repro_torch.kernels.dry
import importlib.util, pathlib
for name in ("quickstart", "elastic_restart", "train_e2e", "serve_adaptive"):
    path = pathlib.Path(sys.argv[1]) / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(",".join(bad))
"""


def test_import_pulls_in_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE, str(EXAMPLES)],
                         env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip() == "", out.stdout


def test_sources_name_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [str(f.relative_to(ROOT)) for f in files
           if FORBIDDEN.search(f.read_text())]
    assert not bad, bad


def test_entry_points_default_to_cuda():
    from repro_torch.kernels.flash_attention import ops  # noqa: F401
    from repro_torch.models import decode, params
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.kvpool import KVBlockPool
    from repro_torch.runtime.trainer import Trainer
    for fn in (ServeEngine, params.init_params, decode.init_cache,
               decode.init_block_pool, KVBlockPool, Trainer):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn


def test_engine_without_device_asks_for_cuda(monkeypatch):
    """Without ``device=`` the engine wants a card: where none is visible
    it raises instead of running on the CPU."""
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.core.topology import ChipletTopology
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(reduced_config(REGISTRY["llama3-8b"]),
                    ChipletTopology(1, 1, 1), EngineConfig(max_len=32))


def test_trainer_without_device_asks_for_cuda(monkeypatch, tmp_path):
    """Without ``device=`` the Trainer wants a card: where none is visible
    it raises instead of training on the CPU."""
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(reduced_config(REGISTRY["llama3.2-3b"]), None,
                TrainerConfig(ckpt_dir=str(tmp_path)))


def load_twin(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", TWINS)
def test_example_twin_names_no_jax_import(name):
    """The port's twin of each example imports the port, and neither JAX
    nor the JAX package."""
    src = (EXAMPLES / f"{name}_torch.py").read_text()
    assert not FORBIDDEN.search(src)
    assert re.search(r"^from repro_torch\.", src, re.M)


@pytest.mark.parametrize("name", TWINS)
def test_example_twin_without_device_asks_for_cuda(name, monkeypatch,
                                                   tmp_path):
    """Each twin's ``main()`` without ``device`` wants a card: where none
    is visible it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {} if name == "serve_adaptive" else {"workdir": str(tmp_path)}
    with pytest.raises(RuntimeError, match="CUDA"):
        load_twin(name).main(**kw)


def test_flash_wrappers_have_no_fallback():
    """The flash-attention wrappers, forward and backward, launch their
    CUDA kernels or raise for a tensor that is not on the CPU."""
    from repro_torch.kernels.flash_attention import ops
    q = torch.empty(1, 8, 2, 16, device="meta")
    kv = torch.empty(1, 8, 1, 16, device="meta")
    lse = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no flash_attention_fwd kernel"):
        ops.flash_attention_fwd(q, kv, kv)
    with pytest.raises(ValueError, match="no flash_attention_bwd kernel"):
        ops.flash_attention_bwd(q, kv, kv, q, lse, q)


def test_kernel_wrapper_has_no_fallback():
    """A tensor that is not on the CPU never reaches the plain version:
    the wrapper launches the CUDA kernel or raises."""
    from repro_torch.kernels.flash_attention import ops
    q = torch.empty(1, 4, 2, 16, device="meta")
    kv = torch.empty(1, 4, 1, 16, device="meta")
    ring = torch.empty(1, 8, 1, 16, device="meta")
    pos = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no ring_chunk_attention kernel"):
        ops.ring_chunk_attention(q, kv, kv, ring, ring, pos, pos)


def test_ssd_wrappers_have_no_fallback():
    """The SSD scan wrapper launches its CUDA kernel or raises for a
    tensor that is not on the CPU, and so does the autograd wrapper that
    calls it."""
    from repro_torch.kernels.ssd_scan import ops
    xdt = torch.empty(2, 8, 4, device="meta")
    a = torch.empty(2, 8, device="meta")
    bc = torch.empty(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no ssd_scan kernel"):
        ops.ssd_scan(xdt, a, bc, bc, chunk=4)
    x = torch.empty(1, 8, 2, 4, device="meta")
    dt = torch.empty(1, 8, 2, device="meta")
    A = torch.empty(2, device="meta")
    B_ = torch.empty(1, 8, 1, 16, device="meta")
    with pytest.raises(ValueError, match="no ssd_scan kernel"):
        ops.ssd_with_state(x, dt, A, B_, B_, 4)


def test_lru_wrappers_have_no_fallback():
    """The RG-LRU scan wrapper, and the autograd wrapper that calls it,
    launch the CUDA kernel or raise for a tensor that is not on the CPU."""
    from repro_torch.kernels.rglru_scan import ops
    a = torch.empty(1, 8, 16, device="meta")
    h0 = torch.empty(1, 16, device="meta")
    with pytest.raises(ValueError, match="no lru_scan kernel"):
        ops.lru_scan(a, a, h0, reverse=True)
    with pytest.raises(ValueError, match="no lru_scan kernel"):
        ops.lru(a, a)


@pytest.mark.parametrize("option,value", [
    ("paged", False), ("lazy", False), ("prefill_mode", "scan")])
def test_unported_options_raise(option, value):
    """The slot monolith, the eager allocator and the scan chunk path,
    which raised until they were ported, build an engine that serves a
    request to its budget.  With them a VLM builds only on the lazy
    paged path (the scan chunk path), and the other two raise a
    ``ValueError`` naming the missing vision extras; an
    encoder-decoder model raises a ``ValueError`` in every mode (the JAX
    engine fails on both later: ``test_torch_vlm_engine.py``)."""
    import numpy as np
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.core.topology import ChipletTopology
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    ecfg = EngineConfig(max_len=32, **{option: value})
    eng = ServeEngine(reduced_config(REGISTRY["llama3-8b"]),
                      ChipletTopology(1, 1, 1), ecfg, device="cpu")
    req = eng.submit(np.arange(2, 22, dtype=np.int32), max_new=3)
    eng.run_until_done()
    assert req.done and len(req.generated) == 3
    vlm = reduced_config(REGISTRY["qwen2-vl-2b"])
    if option == "prefill_mode":
        eng = ServeEngine(vlm, ChipletTopology(1, 1, 1), ecfg, device="cpu")
        req = eng.submit(np.arange(2, 22, dtype=np.int32), max_new=3)
        eng.run_until_done()
        assert req.done and len(req.generated) == 3
    else:
        with pytest.raises(ValueError, match="no vision extras"):
            ServeEngine(vlm, ChipletTopology(1, 1, 1), ecfg, device="cpu")
    with pytest.raises(ValueError, match="no encoder-decoder serving path"):
        ServeEngine(reduced_config(REGISTRY["seamless-m4t-large-v2"]),
                    ChipletTopology(1, 1, 1), ecfg, device="cpu")
