"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the port's entry points run on CUDA
unless the caller asks for the CPU — with no path that quietly falls back
to the CPU or to the plain attention."""
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
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                       r"|from\s+repro(\.|\s+import\b))", re.M)

PROBE = """
import sys
import repro_torch, repro_torch.serving.engine, repro_torch.launch.steps
import repro_torch.kernels.flash_attention.ops, repro_torch.core
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(",".join(bad))
"""


def test_import_pulls_in_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
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
    for fn in (ServeEngine, params.init_params, decode.init_cache,
               decode.init_block_pool, KVBlockPool):
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


@pytest.mark.parametrize("option,value", [
    ("spec_decode", "ngram"), ("async_swap", True), ("paged", False),
    ("lazy", False), ("prefill_mode", "scan")])
def test_unported_options_raise(option, value):
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.core.topology import ChipletTopology
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        ServeEngine(reduced_config(REGISTRY["llama3-8b"]),
                    ChipletTopology(1, 1, 1),
                    EngineConfig(max_len=32, **{option: value}),
                    device="cpu")
