"""Checkpointing: atomic, async, in the JAX package's on-disk layout.

Layout (``checkpoint/manager.py`` of the JAX package, exactly):
<dir>/step_<N>/ with one ``.npy`` per tree leaf, named by its path
(``params/layers/attn/wq`` -> ``params__layers__attn__wq.npy``), bf16
leaves stored as their 16 bits (a uint16 view), and ``manifest.json``
(leaves in path order with file, shape and dtype; user metadata).  A
checkpoint written by the JAX ``CheckpointManager`` restores here and the
reverse.  Writes go to ``<path>.tmp`` and are renamed into place, so a
crashed writer never corrupts the latest checkpoint; ``save(...,
blocking=False)`` serializes on a writer thread and ``wait()`` joins it.

Trees are nested dicts (and lists/tuples) of tensors; ``load_pytree``
restores each leaf onto the device and into the dtype of the matching
leaf of ``like``.  bf16 crosses as an int16 view in torch: no
``ml_dtypes`` is needed; the 8-bit AdamW's int8 and uint8 moments are
numpy's own types.

Elastic restore (reshard-on-load): with ``shardings`` (a matching tree of
``launch.sharding.NamedSharding``) each rank reads, of every leaf, only
the slice its target spec gives it (a memory-mapped ``.npy``), whatever
mesh wrote the checkpoint — a (data=4, model=2) layout restores onto
(data=1, model=8), a different spread_rate or a degraded sub-mesh.
``save(..., shardings=)`` gathers every leaf from the ranks' parts (a
collective: every rank calls it) and the mesh's first rank writes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) in the order ``jax.tree_util`` flattens the same tree:
    dict keys sorted, sequences by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


@dataclasses.dataclass
class _HostLeaf:
    """A leaf copied to the host, as ``save_pytree`` writes it."""
    arr: np.ndarray
    dtype: str          # the manifest's dtype name


def _to_host(leaf) -> _HostLeaf:
    """Host copy of a leaf; bf16 comes out as its uint16 bits."""
    if isinstance(leaf, _HostLeaf):
        return leaf
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return _HostLeaf(arr, str(arr.dtype))
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return _HostLeaf(t.view(torch.int16).numpy().view(np.uint16),
                         "bfloat16")
    arr = t.numpy()
    return _HostLeaf(arr, str(arr.dtype))


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return _to_host(tree)


def save_pytree(path: str, tree, *, metadata: Optional[Dict] = None):
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"leaves": [], "metadata": metadata or {}}
    for name, leaf in _flatten_with_paths(tree):
        host = _to_host(leaf)
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), host.arr)
        manifest["leaves"].append(
            {"path": name, "file": fname, "shape": list(host.arr.shape),
             "dtype": host.dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_pytree(path: str, like, *, shardings=None):
    """Restore into the structure of ``like`` (values replaced), each leaf
    on its ``like`` leaf's device and in its dtype.  ``shardings``: a
    matching tree of ``NamedSharding`` — each leaf is then this rank's
    slice under its spec (read from a memory map).  Returns (tree,
    metadata)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    def sub(t, k):
        return t[k] if t is not None else None

    def restore(node, prefix, shd):
        if isinstance(node, dict):
            return {k: restore(v, f"{prefix}/{k}" if prefix else str(k),
                               sub(shd, k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(restore(v, f"{prefix}/{i}" if prefix else
                                      str(i), sub(shd, i))
                              for i, v in enumerate(node))
        e = by_path[prefix]
        arr = np.load(os.path.join(path, e["file"]),
                      mmap_mode="r" if shd is not None else None)
        if shd is not None:
            from repro_torch.launch.sharding import local_slices
            arr = np.array(arr[local_slices(arr.shape, shd.spec,
                                            shd.mesh.comm())])
        t = _from_numpy(arr, e["dtype"])
        return t.to(device=node.device, dtype=node.dtype)

    return restore(like, "", shardings), manifest["metadata"]


def _first_sharding(shardings):
    while isinstance(shardings, (dict, list, tuple)):
        shardings = (next(iter(shardings.values())) if isinstance(
            shardings, dict) else shardings[0])
    return shardings


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            m = re.match(r"step_(\d+)$", d)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, *, metadata: Optional[Dict] = None,
             blocking: bool = True, shardings=None):
        """Write ``tree`` as step ``step``.  ``shardings``: ``tree`` holds
        this rank's parts — every rank calls ``save``, the leaves are
        gathered, the mesh's first rank writes and (``blocking``) the
        others wait for it."""
        meta = dict(metadata or {}, step=step)
        comm = None
        if shardings is not None:
            from repro_torch.launch.sharding import gather_tree
            comm = _first_sharding(shardings).mesh.comm()
            tree = gather_tree(tree, shardings)
            if comm.rank != comm.mesh.devices.flat[0]:
                if blocking:
                    comm.barrier()
                return
        # copy to the host before handing to the writer thread
        host_tree = _host_tree(tree)
        if blocking:
            save_pytree(self._step_dir(step), host_tree, metadata=meta)
            self._gc()
            if comm is not None:
                comm.barrier()
        else:
            self.wait()

            def _run():
                save_pytree(self._step_dir(step), host_tree, metadata=meta)
                self._gc()

            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, like, *, step: Optional[int] = None, shardings=None):
        self.wait()
        step = step if step is not None else self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return load_pytree(self._step_dir(step), like, shardings=shardings)

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
