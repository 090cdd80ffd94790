"""Metrics registry: counters, gauges, exponential-bucket histograms
(counterpart of ``repro/obs/metrics.py``).

Pure stdlib, thread-safe, host-side only: nothing here imports torch or the
kernel and model modules (``tests/test_torch_obs.py`` checks the imports).
The registry is the one sink for serving metrics — the scheduler, the
prefix cache and the async server write here — and it exports two ways:

- :meth:`MetricsRegistry.snapshot` — a plain JSON-able dict (the ``/v1/
  metrics`` JSON body and the ``benchmarks/serve_bench.py`` artifact);
- :func:`prometheus_text` — Prometheus text exposition format
  (``/v1/metrics?format=prometheus``), with :func:`parse_prometheus` as the
  matching mini-parser so tests validate the exact bytes a scraper would
  see.

Design notes:

- **Labels** are kwargs at lookup time: ``reg.counter("serve_events_total",
  kind="retry")``. Each distinct label set is its own series;
  lookups are get-or-create and return the same object every time, so hot
  paths hold the metric handle instead of re-resolving it.
- **Histograms use exponential buckets** (``start * factor**i``): serving
  latencies span 4+ decades (µs-scale span overhead to multi-second TTFT
  under overload), where linear buckets either blur the head or truncate
  the tail. Counts are kept per-bucket (non-cumulative) internally and
  cumulated only at export, matching Prometheus semantics.
- **Thread safety**: one lock per registry guards series creation; each
  metric carries its own lock for updates. The GIL already makes single
  ``+=`` updates atomic in CPython, but the histogram's (bucket, sum,
  count) triple must move together — and the lock documents intent.
- **Collectors** (the port's addition): :meth:`MetricsRegistry.add_collector`
  takes a callable that a scrape calls for finished metric families. The
  reference's ``qmatmul`` bumps ``qmatmul_dispatch_total`` at trace time,
  which costs nothing at run time; in the port ``qmatmul`` runs on every
  call and a replayed CUDA graph runs no wrapper code, so the kernels'
  launch census (``repro_torch.kernels.census_families``) is read at scrape
  time instead. The registry only calls the collector; whoever registers it
  (the async server) imports the kernels.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# default exponential ladder: 1e-4 * 2**i for 22 buckets → ~0.1 ms .. ~210 s,
# covering span overhead, chunk latencies, TTFT under overload, and makespans
DEFAULT_BUCKET_START = 1e-4
DEFAULT_BUCKET_FACTOR = 2.0
DEFAULT_BUCKET_COUNT = 22


def exponential_buckets(
    start: float = DEFAULT_BUCKET_START,
    factor: float = DEFAULT_BUCKET_FACTOR,
    count: int = DEFAULT_BUCKET_COUNT,
) -> Tuple[float, ...]:
    """Upper bounds ``start * factor**i`` for i in [0, count). The implicit
    final bucket is +Inf (kept out of the tuple; exporters add it)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(
            f"exponential_buckets needs start > 0, factor > 1, count >= 1; "
            f"got start={start}, factor={factor}, count={count}"
        )
    return tuple(start * factor**i for i in range(count))


class Counter:
    """Monotonically increasing count. ``inc`` only goes up — a decrement is
    a programming error, raised loudly (use a Gauge for levels)."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """A level that goes both ways (queue depth, slot occupancy)."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Exponential-bucket histogram: per-bucket counts + sum + count.

    ``observe(v)`` files ``v`` under the first bucket whose upper bound is
    ``>= v`` (overflow goes to the implicit +Inf bucket). Non-finite values
    are counted separately (``nonfinite``) instead of poisoning ``sum`` —
    a NaN latency is a bug upstream, not a data point.
    """

    __slots__ = ("bounds", "_counts", "_inf", "_sum", "_count", "nonfinite", "_lock")

    def __init__(self, bounds: Optional[Sequence[float]] = None) -> None:
        bounds = tuple(bounds) if bounds is not None else exponential_buckets()
        if not bounds or any(b <= a for a, b in zip(bounds, bounds[1:])):
            raise ValueError(f"bucket bounds must be strictly increasing: {bounds}")
        self.bounds = bounds
        self._counts = [0] * len(bounds)
        self._inf = 0
        self._sum = 0.0
        self._count = 0
        self.nonfinite = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        if not math.isfinite(v):
            with self._lock:
                self.nonfinite += 1
            return
        # bisect by hand: bounds are short (~22) and this avoids an import
        idx = None
        for i, b in enumerate(self.bounds):
            if v <= b:
                idx = i
                break
        with self._lock:
            if idx is None:
                self._inf += 1
            else:
                self._counts[idx] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs ending with (+Inf, count) —
        the Prometheus exposition shape."""
        with self._lock:
            out, acc = [], 0
            for b, c in zip(self.bounds, self._counts):
                acc += c
                out.append((b, acc))
            out.append((math.inf, acc + self._inf))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        holding the q-th observation); None when empty. Coarse by design —
        exact percentiles come from ``infer.lifecycle.latency_summary``."""
        if not 0 <= q <= 1:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        cum = self.cumulative()
        total = cum[-1][1]
        if total == 0:
            return None
        rank = q * total
        for bound, acc in cum:
            if acc >= rank:
                return bound
        return math.inf


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create metric series keyed by (name, sorted label items).

    A name is bound to one kind and one label-key set at first use; a later
    lookup with a different kind or label keys raises — silent type morphing
    is how dashboards end up graphing garbage.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> (kind, help, label_keys, bucket bounds or None)
        self._meta: Dict[str, Tuple[str, str, Tuple[str, ...], Optional[Tuple[float, ...]]]] = {}
        # (name, ((k, v), ...)) -> metric
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}
        # key -> callable returning [(name, kind, help, [(labels, value)])]
        self._collectors: Dict[str, Callable[[], Iterable[tuple]]] = {}

    def _get(self, kind: str, name: str, help: str, labels: Dict[str, str],
             buckets: Optional[Sequence[float]] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r} on metric {name!r}")
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        label_keys = tuple(sorted(labels))
        with self._lock:
            meta = self._meta.get(name)
            if meta is None:
                self._meta[name] = (
                    kind, help, label_keys,
                    tuple(buckets) if buckets is not None else None,
                )
            else:
                if meta[0] != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {meta[0]}, "
                        f"requested {kind}"
                    )
                if meta[2] != label_keys:
                    raise ValueError(
                        f"metric {name!r} registered with labels {meta[2]}, "
                        f"requested {label_keys} — one name, one label set"
                    )
            m = self._series.get(key)
            if m is None:
                if kind == "histogram":
                    m = Histogram(self._meta[name][3])
                else:
                    m = _KINDS[kind]()
                self._series[key] = m
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None, **labels) -> Histogram:
        return self._get("histogram", name, help, labels, buckets=buckets)

    def add_collector(self, key: str, fn: Callable[[], Iterable[tuple]]) -> None:
        """Register ``fn`` under ``key`` (a second registration under the same
        key replaces the first). Each export calls it for families
        ``(name, kind, help, [(labels dict, value), ...])`` of counters or
        gauges, read at that moment and exported beside the registry's own
        series; a name the registry already holds is refused at export."""
        with self._lock:
            self._collectors[key] = fn

    def _collected(self) -> List[Tuple[str, str, str, List[Tuple[Dict[str, str], float]]]]:
        with self._lock:
            fns = list(self._collectors.values())
        out = []
        for fn in fns:
            for name, kind, help, samples in fn():
                if not _NAME_RE.match(name) or kind not in ("counter", "gauge"):
                    raise ValueError(f"collector family {name!r} ({kind}) is not a named counter or gauge")
                out.append((name, kind, help, [(dict(ls), float(v)) for ls, v in samples]))
        return sorted(out, key=lambda fam: fam[0])

    # -- export ----------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able view: ``{name: {"type", "help", "series": [{"labels",
        ...values...}]}}``. Histograms carry sum/count/buckets plus coarse
        p50/p95/p99 estimates so the JSON body is directly dashboardable."""
        with self._lock:
            meta = dict(self._meta)
            series = list(self._series.items())
        out: Dict[str, dict] = {}
        for name, (kind, help, _keys, _buckets) in sorted(meta.items()):
            out[name] = {"type": kind, "help": help, "series": []}
        for (name, labels), m in sorted(series, key=lambda kv: kv[0]):
            entry: dict = {"labels": dict(labels)}
            if isinstance(m, Histogram):
                entry["count"] = m.count
                entry["sum"] = m.sum
                entry["buckets"] = [
                    ["+Inf" if math.isinf(b) else b, c] for b, c in m.cumulative()
                ]
                entry["p50"] = m.quantile(0.50)
                entry["p95"] = m.quantile(0.95)
                entry["p99"] = m.quantile(0.99)
                if m.nonfinite:
                    entry["nonfinite"] = m.nonfinite
            else:
                entry["value"] = m.value
            out[name]["series"].append(entry)
        for name, kind, help, samples in self._collected():
            if name in out:
                raise ValueError(f"collector family {name!r} duplicates a registered metric")
            out[name] = {"type": kind, "help": help,
                         "series": [{"labels": ls, "value": v} for ls, v in samples]}
        return out


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels: Dict[str, str], extra: Optional[Tuple[str, str]] = None) -> str:
    items = list(labels.items())
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    body = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in items
    )
    return "{" + body + "}"


def prometheus_text(*registries: MetricsRegistry) -> str:
    """Prometheus text exposition (v0.0.4) over one or more registries —
    the async server concatenates its own registry with the process-global
    :func:`default_registry` (the kernels' launch census, through its
    collector) into one scrape."""
    lines: List[str] = []
    seen_names = set()
    for reg in registries:
        with reg._lock:
            meta = dict(reg._meta)
            series = sorted(reg._series.items(), key=lambda kv: kv[0])
        for name, (kind, help, _keys, _buckets) in sorted(meta.items()):
            if name in seen_names:
                raise ValueError(
                    f"metric {name!r} exported by more than one registry — "
                    "a scrape must not carry duplicate metric families"
                )
            seen_names.add(name)
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            for (sname, labels), m in series:
                if sname != name:
                    continue
                ld = dict(labels)
                if isinstance(m, Histogram):
                    for bound, acc in m.cumulative():
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(ld, ('le', _fmt_value(bound)))} {acc}"
                        )
                    lines.append(f"{name}_sum{_fmt_labels(ld)} {_fmt_value(m.sum)}")
                    lines.append(f"{name}_count{_fmt_labels(ld)} {m.count}")
                else:
                    lines.append(f"{name}{_fmt_labels(ld)} {_fmt_value(m.value)}")
        for name, kind, help, samples in reg._collected():
            if name in seen_names:
                raise ValueError(
                    f"metric {name!r} exported by more than one registry — "
                    "a scrape must not carry duplicate metric families"
                )
            seen_names.add(name)
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in samples:
                lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$"
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Strict mini-parser for the exposition format: returns
    ``{sample_name: [(labels, value), ...]}``. Raises ``ValueError`` on any
    malformed line — the tests and ``chip_smoke.py`` scrape through this,
    so an export regression fails loudly instead of silently scraping junk."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            if not (line.startswith("# HELP ") or line.startswith("# TYPE ")):
                raise ValueError(f"line {lineno}: malformed comment {raw!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample {raw!r}")
        labels: Dict[str, str] = {}
        body = m.group("labels")
        if body:
            consumed = 0
            for pm in _LABEL_PAIR_RE.finditer(body):
                labels[pm.group(1)] = pm.group(2)
                consumed += len(pm.group(0))
            # commas between pairs
            if consumed + max(0, len(labels) - 1) != len(body):
                raise ValueError(f"line {lineno}: malformed labels {body!r}")
        v = m.group("value")
        if v == "+Inf":
            value = math.inf
        elif v == "-Inf":
            value = -math.inf
        elif v == "NaN":
            value = math.nan
        else:
            try:
                value = float(v)
            except ValueError:
                raise ValueError(f"line {lineno}: malformed value {v!r}") from None
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


_DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry. The async server registers the kernels'
    launch census on it as a collector (``kernel_launches_total`` and its
    kin, read at scrape time) and merges it into its scrape via
    :func:`prometheus_text`."""
    return _DEFAULT_REGISTRY


def counters_agree(registry: MetricsRegistry, counters: Dict[str, float],
                   prefix: str = "serve_", suffix: str = "_total") -> List[str]:
    """Diff helper for the accounting tests: returns the mismatches between a
    scheduler's host-side ``counters`` dict and the registry series named
    ``{prefix}{key}{suffix}`` (empty list == perfect agreement)."""
    snap = registry.snapshot()
    problems = []
    for key, want in sorted(counters.items()):
        name = f"{prefix}{key}{suffix}"
        fam = snap.get(name)
        if fam is None:
            if want:
                problems.append(f"{name}: missing from registry (counters={want})")
            continue
        got = sum(s.get("value", 0.0) for s in fam["series"])
        if got != want:
            problems.append(f"{name}: registry={got} counters={want}")
    return problems
