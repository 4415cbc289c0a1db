"""Counting over a traced step: flops, bytes, memory, kernel launches,
collective bytes and the roofline.

The port's counterpart of the JAX package's ``launch/hlo_analysis.py``.
JAX lowers and compiles a step and parses the optimized HLO text; the
port has no compiler that lowers a step without running it, so the dry
run (``launch/dryrun.py``) runs the port's own step functions on tensors
that hold no data (``torch._subclasses.fake_tensor.FakeTensorMode``,
``kernels/dry.py``) under ``Trace``, a ``TorchDispatchMode`` that sees
every aten op as it runs:

* flops: each op's count from ``torch.utils.flop_counter``'s formulas
  (``flop_registry``: the matmuls, convolutions and PyTorch's attention),
  plus the needed work that each hand-written kernel's wrapper notes in
  place of its launch.  (``FlopCounterMode`` itself is not used: its
  ``bmm`` formula fails on the ``out_dtype`` overload that
  ``layers.matmul_f32`` calls.)
* bytes accessed: every aten op's tensor inputs and outputs, views and
  uninitialized allocations excepted, plus the kernels' noted bytes — the
  same "every unfused operand" upper bound as XLA's ``bytes accessed``.
* memory: the bytes of the device storages alive at each op, each
  rounded up to the CUDA caching allocator's 512-byte granule; the peak,
  with the arguments (alive when the step starts), the outputs and the
  temporaries apart.
* launches a step of each hand-written kernel, from the wrappers' notes.

Every layer, microbatch and recomputation runs in Python and is counted
as it runs, so nothing is counted once per loop: the HLO parse's trip
counts (``parse_computations``, ``while_trip_counts``, ``while_loops``)
have no counterpart.  ``model_steps_per_call`` has one already
(``ServeEngine.measured_model_steps`` and ``decode.layer_walks``), and
``collective_bytes(hlo)`` too: every collective goes through
``launch.mesh.MeshComm``, which counts its operand bytes by link class
and op (``collective_stats`` reads them).

``Roofline`` takes rates of the card (``PEAK_FLOPS``, ``HBM_BW``,
``LINK_BW``), datasheet figures of NVIDIA H100 80GB HBM3 (SXM, 700 W),
not measurements: 989e12 dense bf16 FLOP/s on the tensor cores, 3.35e12
bytes/s of HBM3, and 50e9 bytes/s of one 400 Gb/s NDR InfiniBand port a
card — a production mesh's 16-wide ``model`` group spans two 8-card
hosts, so every link class crosses that port.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import dry

PEAK_FLOPS = 989e12          # dense bf16 on the tensor cores, data sheet
HBM_BW = 3.35e12             # HBM3 bytes/s, data sheet
LINK_BW = 50e9               # one 400 Gb/s NDR port a card
CARD_BYTES = 79.18 * 2 ** 30  # what torch.cuda reports for the 80 GB card
ALLOC_GRANULE = 512          # the caching allocator's rounding

_aten = torch.ops.aten
# allocations that write nothing, and ops that only rename storage
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default, _aten._unsafe_view.default,
             _aten.lift_fresh.default}
_DEVICE = torch.ops.prim.device.default
# matmuls whose ``out_dtype`` overload passes the type positionally
_TWO_OPERANDS = {_aten.mm, _aten.bmm}


def trace_device(device: str) -> str:
    """The device a dry trace's fake tensors take: ``device``, but
    ``meta`` for ``cuda`` where PyTorch was built without CUDA — autograd
    on a fake ``cuda`` tensor asks for the CUDA device guard there and
    aborts the process.  The wrappers and ``layers.matmul_f32`` route a
    fake ``meta`` tensor as the card's (``kernels/dry.py``)."""
    if device == "cuda" and not torch.backends.cuda.is_built():
        return "meta"
    return device


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors in nested lists, tuples and dicts (an op's arguments
    and results)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


class Trace(TorchDispatchMode):
    """The counting context.  Enter it inside a ``FakeTensorMode``; make
    the step's arguments, call ``begin()``, run the
    step, call ``end(outputs)``.  Attributes: ``flops``,
    ``bytes_accessed``, ``launches`` (kernel -> count), ``kernel_flops``
    and ``kernel_bytes`` (kernel -> noted work), ``peak_bytes``,
    ``argument_bytes``, ``output_bytes``, ``alias_bytes``; ``memory()``
    gives them in the JAX record's keys."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.launches: Dict[str, int] = {}
        self.kernel_flops: Dict[str, float] = {}
        self.kernel_bytes: Dict[str, float] = {}
        self.live = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self.alias_bytes = 0
        self._storages: Dict[int, int] = {}
        self._arguments: set = set()
        self._sink = None

    # -- kernels ------------------------------------------------------------
    def _note(self, name, n_bytes, flops):
        self.launches[name] = self.launches.get(name, 0) + 1
        self.kernel_flops[name] = self.kernel_flops.get(name, 0.0) + flops
        self.kernel_bytes[name] = self.kernel_bytes.get(name, 0.0) + n_bytes
        self.flops += flops
        self.bytes_accessed += n_bytes

    def __enter__(self):
        self._sink = dry.sinks(self._note)
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._sink.__exit__(*exc)

    # -- memory -------------------------------------------------------------
    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = -(-st.nbytes() // ALLOC_GRANULE) * ALLOC_GRANULE
        self._storages[key] = n
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._storages.pop(key, 0)
        self._arguments.discard(key)

    def begin(self):
        """The step starts: what is alive now is its arguments."""
        self.argument_bytes = self.live
        self.peak_bytes = self.live
        self._arguments = set(self._storages)
        self.flops = self.bytes_accessed = 0.0
        self.launches, self.kernel_flops, self.kernel_bytes = {}, {}, {}

    def end(self, outputs):
        """The step returned ``outputs``: split their storages into those
        that were arguments (updated in place) and new ones."""
        seen = set()
        for t in _tensors(outputs):
            key = id(t.untyped_storage())
            if key in seen or key not in self._storages:
                continue
            seen.add(key)
            if key in self._arguments:
                self.alias_bytes += self._storages[key]
            else:
                self.output_bytes += self._storages[key]

    def memory(self) -> Dict[str, float]:
        """The JAX record's ``memory`` keys, measured on the trace:
        ``peak_per_device`` is the most bytes alive at once;
        ``temp_bytes`` what the peak holds beyond the arguments;
        ``alias_bytes`` the arguments the outputs return (updated in
        place); ``fits_hbm_80gb`` whether the peak fits ``CARD_BYTES``."""
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.peak_bytes - self.argument_bytes,
                "alias_bytes": self.alias_bytes,
                "peak_per_device": self.peak_bytes,
                "fits_hbm_80gb": bool(self.peak_bytes <= CARD_BYTES)}

    # -- the ops ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _DEVICE:             # a ``.device`` read: no work
            return func(*args)
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        how = _HOW.get(func)
        if how is None:
            how = _HOW[func] = _how(func)
        count, moves = how
        if count is not None:
            if func._overloadpacket in _TWO_OPERANDS:
                self.flops += count(*args[:2], out_val=out)
            else:
                self.flops += count(*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if moves:
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in _tensors(kwargs, _tensors(args, list(outs))))
        for t in outs:
            self._track(t)
        return out


# func -> (its flop formula or None, whether it moves bytes)
_HOW: Dict = {}


def _how(func):
    moves = (not func.is_view and func not in _NO_BYTES
             and func.namespace != "prim")
    return flop_registry.get(func._overloadpacket), moves


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CollectiveStats:
    per_class_bytes: Dict[str, float]
    per_op_bytes: Dict[str, float]
    n_ops: int
    details: List[Dict]

    @property
    def total_bytes(self) -> float:
        return sum(self.per_class_bytes.values())

    @property
    def remote_bytes(self) -> float:
        return (self.per_class_bytes.get("intra_pod", 0.0)
                + self.per_class_bytes.get("cross_pod", 0.0))


def collective_stats(comm) -> CollectiveStats:
    """A ``MeshComm``'s operand bytes on its rank, by class and by op."""
    return CollectiveStats(dict(comm.bytes), dict(comm.op_bytes),
                           comm.n_ops, [])


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops_total: float
    chips: int

    @property
    def dominant(self) -> str:
        t = {"compute": self.compute_s, "memory": self.memory_s,
             "collective": self.collective_s}
        return max(t, key=t.get)

    @property
    def hlo_flops_total(self) -> float:
        """Every rank's traced flops (the JAX name is kept)."""
        return self.flops_per_dev * self.chips

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / traced flops (remat and redundancy waste)."""
        return self.model_flops_total / max(self.hlo_flops_total, 1.0)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / achievable step time (higher is better)."""
        useful = self.model_flops_total / (self.chips * PEAK_FLOPS)
        return useful / max(self.bound_s, 1e-30)

    def to_dict(self):
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "model_flops_total": self.model_flops_total,
            "chips": self.chips, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline(*, flops_per_dev: float, bytes_per_dev: float,
             coll_bytes_per_dev: float, model_flops_total: float,
             chips: int) -> Roofline:
    return Roofline(
        compute_s=flops_per_dev / PEAK_FLOPS,
        memory_s=bytes_per_dev / HBM_BW,
        collective_s=coll_bytes_per_dev / LINK_BW,
        flops_per_dev=flops_per_dev,
        bytes_per_dev=bytes_per_dev,
        coll_bytes_per_dev=coll_bytes_per_dev,
        model_flops_total=model_flops_total,
        chips=chips)
