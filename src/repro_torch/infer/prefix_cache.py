"""Radix-trie prefix cache over committed token prefixes (counterpart of
``repro/infer/prefix_cache.py``).

At serving scale much of the prefill is redundant: every request sharing a
system prompt recomputes the same KV rows. This module indexes committed
prompt prefixes in a radix trie of fixed-size token blocks, each block
backed by device-resident cache rows, so an admission installs the shared
prefix and prefills only the uncached suffix (``Engine.begin_admission``
consults it).

Structure
---------
- One trie node per block of ``block_tokens`` consecutive token ids; the
  child edge key is the block's raw token bytes, so lookup is exact (no
  hash-collision false sharing) and O(plen / block_tokens).
- A node owns its block's cache rows: ``{"k", "v"}`` of shape
  ``(repeat, 1, block_tokens, Hkv, Dh)`` per stage block, gathered by
  :func:`repro_torch.models.layers.gather_prefix_rows` as a **copy** of the
  batch-1 cache's rows. A view would keep the whole cache alive, make
  ``nbytes`` understate what the block holds, and let a later write into
  that cache change a committed block.
- Nodes are **ref-counted**: :meth:`PrefixCache.begin` pins the matched path
  for the lifetime of the admission; :meth:`PrefixCache.complete` /
  :meth:`PrefixCache.abort` unpin. Pinned nodes are never evicted, and an
  install copies the rows, so an eviction after install cannot change a
  request's tokens.
- **LRU eviction** keeps ``cached_bytes <= max_bytes``: only childless,
  unpinned nodes are candidates (chains drain leaf-first), oldest
  ``last_used`` first.
- The cache is bound to one ``(model, quant-policy)`` identity
  (:func:`model_identity`): an engine with another config, quantization
  policy or per-leaf format refuses to share it.

Accounting invariants (``tests/test_torch_prefix_cache.py``)::

    hits + misses == commits + aborts     # every begin() ends exactly once
    pinned == 0                           # at shutdown / between requests

Host-side only: the trie, refcounts and LRU live on the host; the rows are
tensors the engine gathers and installs.

Not ported: the reference's ``pad_rows``, which zero-pads an install to a
power-of-two row bucket so XLA compiles one install per bucket; an install
here copies the exact rows. The recurrent boundary snapshots (``snap``) are
carried as ``None``: the port has no recurrent family yet.

Observability (``repro_torch.obs``): with a registry the counters are
mirrored as ``prefix_<key>_total`` beside the cached-bytes, trie-size and
pin gauges, and with a tracer each eviction is an ``evict`` instant on the
scheduler lane; a scheduler hands the cache its own through
:meth:`PrefixCache.attach` when none were given.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.utils import tree_leaves, tree_map_with_path


def check_observers(metrics, tracer, who: str) -> None:
    """Refuse a ``metrics`` without a :class:`~repro_torch.obs.MetricsRegistry`'s
    ``counter`` / ``gauge`` / ``histogram`` or a ``tracer`` without a
    :class:`~repro_torch.obs.Tracer`'s ``span`` / ``instant`` / ``complete``
    (None: off), before a hook would fail mid-run."""
    for given, what, names in ((metrics, "metrics registry", ("counter", "gauge", "histogram")),
                               (tracer, "span tracer", ("span", "instant", "complete"))):
        if given is not None and not all(callable(getattr(given, n, None)) for n in names):
            raise ValueError(f"{who}: metrics / tracer: a {what} needs {', '.join(names)} "
                             f"(repro_torch.obs), got {type(given).__name__}")


def model_identity(cfg, params) -> str:
    """Digest of the (model, quant-policy) identity a prefix cache keys on:
    ``repr(cfg)``, and every parameter leaf's path with, for a
    :class:`~repro_torch.core.qtensor.QuantizedTensor`, its format tag and
    ``(q, g, k, o)``, for a dense leaf its dtype and shape. Weight values
    are deliberately not hashed; the identity guards against sharing a cache
    across quantization policies or architectures, not against loading
    other weights into the same shapes."""
    parts = [repr(cfg)]

    def visit(path, leaf):
        name = "".join(f"[{p!r}]" for p in path)
        if isinstance(leaf, QuantizedTensor):
            parts.append(f"{name}:{leaf.fmt}:q{leaf.q}:g{leaf.g}:{leaf.k}x{leaf.o}")
        else:
            parts.append(f"{name}:dense:{leaf.dtype}:{tuple(leaf.shape)}")
        return leaf

    tree_map_with_path(visit, params)
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def concat_rows(rows_list):
    """Concatenate per-block row trees along the row axis (axis 2)."""

    def cat(path, first):
        xs = [_at(r, path) for r in rows_list]
        return torch.cat(xs, dim=2)

    return tree_map_with_path(cat, rows_list[0])


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _tree_nbytes(tree) -> int:
    return sum(int(x.nbytes) for x in tree_leaves(tree))


class _Node:
    __slots__ = ("key", "tokens", "parent", "children", "rows", "snap", "nbytes", "refs", "last_used", "end")

    def __init__(self, key: bytes, tokens, parent, rows, snap, end: int):
        self.key = key
        self.tokens = tokens
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}
        self.rows = rows
        self.snap = snap
        self.nbytes = _tree_nbytes(rows) + (0 if snap is None else _tree_nbytes(snap))
        self.refs = 0
        self.last_used = 0
        self.end = end  # prefix length (tokens) through this node


@dataclasses.dataclass
class PrefixHandle:
    """One admission's view of the cache: the pinned matched path and the
    commit plan for the blocks the prompt would add. The engine fills
    ``rows`` / ``snaps`` (aligned with ``new_spans``) when it finishes the
    admission; then :meth:`PrefixCache.complete` commits them, or
    :meth:`PrefixCache.abort` releases the pins if the admission died."""

    tokens: np.ndarray  # the full prompt, host int32
    matched: List[_Node]  # pinned root → leaf path
    length: int  # matched prefix tokens
    new_spans: List[Tuple[int, int]]  # blocks to commit: [(start, end))
    rows: List[object] = dataclasses.field(default_factory=list)
    snaps: List[Optional[object]] = dataclasses.field(default_factory=list)
    closed: bool = False


class PrefixCache:
    """Ref-counted, LRU-evicted radix trie of device-resident prefix blocks.

    ``block_tokens`` is the trie granularity (a prefix is reusable in
    multiples of it); ``max_bytes`` bounds the device bytes held by
    committed blocks. ``metrics`` / ``tracer`` (a
    :class:`~repro_torch.obs.MetricsRegistry` / :class:`~repro_torch.obs.Tracer`)
    mirror the counters into ``prefix_<key>_total`` with cached-bytes and
    trie-size gauges, and record ``evict`` instants; the scheduler attaches
    its own through :meth:`attach` when none were given."""

    def __init__(self, *, block_tokens: int = 16, max_bytes: int = 64 << 20, metrics=None, tracer=None):
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        check_observers(metrics, tracer, "PrefixCache")
        self.block_tokens = block_tokens
        self.max_bytes = max_bytes
        self.metrics = metrics
        self.tracer = tracer
        self._root = _Node(b"", None, None, {}, None, 0)
        self._nodes: List[_Node] = []  # every non-root node (small; scans are fine)
        self._bytes = 0
        self._tick = 0
        self._model_key: Optional[str] = None
        self.counters: Dict[str, int] = {"hits": 0, "misses": 0, "commits": 0, "aborts": 0, "evictions": 0}
        if metrics is not None:
            self._register_series()

    # -- observability -------------------------------------------------------

    def attach(self, metrics=None, tracer=None) -> None:
        """Adopt a registry / tracer where none was given at construction
        (the scheduler calls this, so serve and prefix metrics share one
        exporter)."""
        check_observers(metrics, tracer, "PrefixCache.attach")
        if self.metrics is None and metrics is not None:
            self.metrics = metrics
            self._register_series()
        if self.tracer is None and tracer is not None:
            self.tracer = tracer

    def _register_series(self) -> None:
        for key in self.counters:
            self.metrics.counter(f"prefix_{key}_total", f"prefix cache events: {key}")
        self._set_gauges()

    def _set_gauges(self) -> None:
        if self.metrics is None:
            return
        self.metrics.gauge("prefix_cached_bytes", "device bytes held by committed blocks").set(self._bytes)
        self.metrics.gauge("prefix_trie_nodes", "committed prefix blocks in the trie").set(len(self._nodes))
        self.metrics.gauge("prefix_pinned_refs", "outstanding pins (in-flight admissions)").set(self.pinned)

    # -- identity ------------------------------------------------------------

    def bind(self, model_key: str) -> None:
        """The first bind wins; a later engine with another identity refuses
        to share the cache (its rows would be garbage for that model)."""
        if self._model_key is None:
            self._model_key = model_key
        elif self._model_key != model_key:
            raise ValueError(
                f"prefix cache is bound to model identity {self._model_key!r}; refusing to serve "
                f"{model_key!r} — one PrefixCache per (model, quant-policy)"
            )

    # -- stats ---------------------------------------------------------------

    @property
    def cached_bytes(self) -> int:
        return self._bytes

    @property
    def n_nodes(self) -> int:
        return len(self._nodes)

    @property
    def pinned(self) -> int:
        return sum(n.refs for n in self._nodes)

    def stats(self) -> dict:
        return {
            "nodes": len(self._nodes),
            "cached_bytes": self._bytes,
            "pinned": self.pinned,
            "block_tokens": self.block_tokens,
            "max_bytes": self.max_bytes,
            **self.counters,
        }

    # -- the admission protocol ----------------------------------------------

    def begin(self, tokens, *, max_match: int, max_commit: int) -> PrefixHandle:
        """Match and pin: walk the trie over the prompt's leading blocks, pin
        the matched path, and plan which new blocks a commit would add.

        ``max_match`` caps the reusable prefix (the engine passes ``plen - 1``:
        at least the last prompt token must prefill, for its logits);
        ``max_commit`` caps the committable prefix. Every ``begin`` is ended
        by exactly one ``complete`` or ``abort``."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bt = self.block_tokens
        self._tick += 1
        node, matched, length = self._root, [], 0
        while length + bt <= max_match:
            child = node.children.get(tokens[length : length + bt].tobytes())
            if child is None:
                break
            matched.append(child)
            node = child
            length += bt
        for n in matched:
            n.refs += 1
            n.last_used = self._tick
        want = (max(0, max_commit) // bt) * bt
        spans = [(s, s + bt) for s in range(length, want, bt)]
        self._count("hits" if length else "misses")
        return PrefixHandle(tokens=tokens, matched=matched, length=length, new_spans=spans)

    def complete(self, handle: PrefixHandle) -> None:
        """Commit the handle's new blocks (rows filled by the engine) and
        unpin its matched path. Idempotent; racing identical commits (two
        requests with the same prompt in flight) keep the first-inserted
        block and drop the duplicate rows."""
        if handle.closed:
            return
        handle.closed = True
        self._tick += 1
        node = handle.matched[-1] if handle.matched else self._root
        for i, (s, e) in enumerate(handle.new_spans):
            if i >= len(handle.rows):
                break  # the engine captured fewer blocks than planned
            key = handle.tokens[s:e].tobytes()
            child = node.children.get(key)
            if child is None:
                snap = handle.snaps[i] if i < len(handle.snaps) else None
                child = _Node(key, handle.tokens[s:e].copy(), node, handle.rows[i], snap, e)
                node.children[key] = child
                self._nodes.append(child)
                self._bytes += child.nbytes
            child.last_used = self._tick
            node = child
        self._unpin(handle)
        self._count("commits")
        self._evict_to_budget()
        self._set_gauges()

    def abort(self, handle: PrefixHandle) -> None:
        """Unpin without committing (the admission failed or was cancelled
        mid-prefill). Idempotent."""
        if handle.closed:
            return
        handle.closed = True
        self._unpin(handle)
        self._count("aborts")
        self._set_gauges()

    def _count(self, key: str, n: int = 1) -> None:
        self.counters[key] += n
        if self.metrics is not None:
            self.metrics.counter(f"prefix_{key}_total").inc(n)

    def _unpin(self, handle: PrefixHandle) -> None:
        for n in handle.matched:
            assert n.refs > 0, "refcount underflow: begin/complete mismatch"
            n.refs -= 1

    # -- eviction ------------------------------------------------------------

    def _evictable(self) -> List[_Node]:
        return [n for n in self._nodes if not n.children and n.refs == 0]

    def _evict_one(self, node: _Node) -> None:
        del node.parent.children[node.key]
        self._nodes.remove(node)
        self._bytes -= node.nbytes
        node.rows = node.snap = None  # drop the device references now
        self._count("evictions")
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant(
                "evict", cat="prefix", lane="scheduler",
                args={"block_end": node.end, "nbytes": node.nbytes, "cached_bytes": self._bytes,
                      "nodes": len(self._nodes)},
            )

    def _evict_to_budget(self) -> None:
        while self._bytes > self.max_bytes:
            victims = self._evictable()
            if not victims:
                return  # everything live is pinned or interior: over budget
            self._evict_one(min(victims, key=lambda n: n.last_used))

    def evict_to(self, max_bytes: int) -> None:
        """Shrink the budget and evict down to it at once (a memory-pressure
        hook; also how the tests evict mid-flight)."""
        self.max_bytes = max_bytes
        self._evict_to_budget()
        self._set_gauges()
