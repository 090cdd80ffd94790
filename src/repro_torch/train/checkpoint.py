"""Fault-tolerant checkpointing: atomic, resumable, elastic (counterpart of
``repro/train/checkpoint.py``, with its on-disk layout, so each package
reads the other's checkpoints).

- **Layout**: ``<dir>/step_<n>/leaf_<i>.npy`` a leaf plus ``manifest.json``
  (``{"step", "leaves": [{"key", "file", "shape", "dtype"}]}``). A leaf's
  key is the string JAX's ``tree_util`` gives its path in the same tree:
  a dict key ``['name']``, a tuple index ``[0]``, a dataclass field ``.m``,
  joined by ``/``; leaves are numbered in JAX's flattening order (dict keys
  sorted, dataclass fields in declaration order). bfloat16 (and the float8
  types) are stored as their unsigned-integer bits, the true dtype in the
  manifest.
- **Atomic**: a step is written to ``<dir>/tmp.<step>`` and then
  ``os.replace``-d to ``<dir>/step_<n>``: a crash mid-write never leaves a
  partial checkpoint that counts.
- **Resumable**: ``latest_step`` / ``restore`` let the train loop resume
  from the newest complete checkpoint.
- **Elastic**: leaves are whole arrays; ``restore`` matches them by key onto
  a template tree and gives each the template leaf's dtype and device, so a
  checkpoint written on the CPU restores onto the card and back.
- **Async**: ``AsyncCheckpointer`` hands host copies to a writer thread, so
  the step loop does not wait on the disk.
- **Retention**: the newest ``keep`` checkpoints are kept.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import re
import shutil
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")

# dtypes numpy cannot hold, stored as the unsigned integers of their bits:
# torch dtype → (manifest name, stored numpy dtype, an integer dtype of that
# width both torch and numpy hold, in each package)
_EXOTIC = {
    torch.bfloat16: ("bfloat16", np.uint16, torch.int16, np.int16),
    torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8, np.uint8),
    torch.float8_e5m2: ("float8_e5m2", np.uint8, torch.uint8, np.uint8),
}
_EXOTIC_BY_NAME = {name: (dt, width) for dt, (name, _, _, width) in _EXOTIC.items()}


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key string, child) of a container in JAX's flattening order, or None
    for a leaf. None is an empty container, as in JAX."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) of every leaf, in JAX's flattening order, keyed as JAX's
    ``keystr`` pieces joined by ``/`` (module docstring)."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(leaf_paths(child, f"{prefix}/{key}" if prefix else key))
    return out


def map_leaves(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``; containers keep
    their type (a dataclass through ``dataclasses.replace``)."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    done = {key: map_leaves(fn, child, f"{prefix}/{key}" if prefix else key) for key, child in kids}
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: done[f"[{k!r}]"] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(done[f"[{i}]"] for i in range(len(tree)))
    return dataclasses.replace(tree, **{f.name: done[f".{f.name}"] for f in dataclasses.fields(tree)})


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array written to disk and its true dtype's name."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu()
    if t.dtype in _EXOTIC:
        name, store, width, _ = _EXOTIC[t.dtype]
        return t.view(width).numpy().view(store), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = arr if arr.flags.c_contiguous else arr.copy()  # (np.ascontiguousarray makes a 0-d array 1-d)
    if dtype_name in _EXOTIC_BY_NAME:
        dt, width = _EXOTIC_BY_NAME[dtype_name]
        return torch.from_numpy(arr.view(width)).view(dt)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, state: Any, *, keep: int = 3) -> str:
    """Blocking atomic save. Returns the final checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(leaf_paths(state)):
        arr, true_dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        manifest["leaves"].append(
            {"key": key, "file": f"leaf_{i}.npy", "shape": list(arr.shape), "dtype": true_dtype}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list:
    """Steps with a complete checkpoint (a ``step_<n>`` holding its manifest)."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, template: Any) -> Any:
    """Load into ``template``'s structure: each leaf matched by key, checked
    against the template leaf's shape, and given its dtype and device (a
    template leaf that is not a tensor gives a CPU tensor)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}

    def load(key, leaf):
        entry = by_key.get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(path, entry["file"]))
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs template {shape}")
        value = _from_numpy(arr, entry["dtype"])
        if isinstance(leaf, torch.Tensor):
            return value.to(device=leaf.device, dtype=leaf.dtype)
        return value

    return map_leaves(load, template)


def host_copy(state: Any) -> Any:
    """``state`` with every tensor leaf copied to the host: a copy even of a
    CPU tensor, so later in-place updates (the train step's) do not reach
    it."""
    return map_leaves(lambda _, x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x, state)


class AsyncCheckpointer:
    """Background-thread writer: ``submit`` returns once the host copy is
    made (:func:`host_copy`, before the queue); the previous write is
    awaited first (at most one in flight)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, state = item
            try:
                save(self.ckpt_dir, step, state, keep=self.keep)
            except BaseException as e:  # surfaced on the next submit / close
                self._err = e

    def submit(self, step: int, state: Any) -> None:
        if self._err:
            raise RuntimeError("async checkpoint failed") from self._err
        self._q.put((step, host_copy(state)))  # blocks while one is in flight

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise RuntimeError("async checkpoint failed") from self._err
