"""Serving telemetry: request-lifecycle tracing, percentile metrics, and
Chrome-trace (Perfetto) export.

A pure-Python copy of the reference's ``repro/serving/telemetry.py``: that
module cannot be imported from the port because ``repro/serving/__init__``
imports the JAX engine.

The paper's core *method* is measurement-driven bottleneck analysis: Ara2
instruments functional-unit utilization per kernel (§5-6) to pinpoint
whether the scalar core, the memories, or the vector architecture gates
throughput, and AraOS extends the same methodology to price
virtual-memory management on the vector unit.  This module gives the
serving stack the same instrument: instead of a single mean TTFT and a
final occupancy number, every request's lifecycle (enqueue -> admit ->
chunked prefill -> decode stretches -> preempt -> requeue -> finish),
every pool event (alloc/free/COW/reservation, free-block watermark), and
every replica step (dispatch vs device time) becomes a timestamped event
that can be aggregated into percentiles or opened as a timeline in
Perfetto.

Three pieces:

* :class:`Tracer` / :class:`NullTracer` - a span / instant / counter /
  flow event recorder.  ``NullTracer`` (the default everywhere) is a
  no-op whose methods exist so call sites never branch on None; hot
  paths additionally guard on ``tracer.enabled`` so the untraced decode
  step pays a single attribute check (the overhead contract in
  ``docs/observability.md``, bounded by a bench row).  ``Tracer`` is
  thread-safe (one lock around the event list) and takes an injectable
  :class:`Clock`, so the future async cluster driver can adopt it
  unchanged and tests can drive a :class:`FakeClock` for deterministic
  latency math.

* :class:`MetricsRegistry` - named counters / gauges / histograms /
  timelines.  Histograms keep raw samples, so percentiles are exact
  (nearest-rank) and registries merge losslessly - the cluster
  aggregates replica histograms instead of averaging replica means.

* :func:`Tracer.chrome_trace` / :func:`Tracer.export` - the Chrome
  trace-event JSON exporter (the ``traceEvents`` array format both
  Perfetto and chrome://tracing load): one named track per recorded
  track string (replicas, their slots, the pool, the cluster router),
  request spans as complete ("X") events that nest by containment,
  preempt -> requeue handoffs as flow ("s"/"f") arrows, pool watermarks
  as counter ("C") series.

:func:`validate_lifecycle` is the event-stream conformance check the
property suite runs over random traces: admits precede decodes, every
preempt is answered by a requeue or abort, and per-request block
acquisitions balance releases.
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from typing import Any


# ---------------------------------------------------------------------------
# Clocks.
# ---------------------------------------------------------------------------

class MonotonicClock:
    """The default wall clock (``time.perf_counter``, seconds)."""

    @staticmethod
    def now() -> float:
        return time.perf_counter()


class FakeClock:
    """Deterministic test clock: ``now()`` returns the current time and
    then advances it by ``tick`` (plus any manual ``advance`` calls), so
    latency math in tests is exact instead of sleep/flake-prone."""

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self._t = float(start)
        self.tick = float(tick)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            t = self._t
            self._t += self.tick
            return t

    def advance(self, dt: float) -> None:
        with self._lock:
            self._t += dt


MONOTONIC = MonotonicClock()


# ---------------------------------------------------------------------------
# Tracer.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Event:
    """One recorded trace event (host-side representation; the Chrome
    JSON shape is produced at export).  ``ph`` follows the trace-event
    phase codes: "X" complete span, "i" instant, "C" counter, "s"/"f"
    flow start/finish."""
    ph: str
    track: str
    name: str
    ts: float                      # clock seconds
    dur: float = 0.0               # span length (ph == "X")
    args: dict = dataclasses.field(default_factory=dict)
    fid: str = ""                  # flow id (ph in "sf")


class _NullSpan:
    """Reusable no-op context manager (``NullTracer.span``)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Zero-overhead default tracer: every method is a no-op.

    Hot paths (the per-step decode loop) guard on ``enabled`` so the
    untraced engine pays one attribute check per potential event; cold
    paths may call methods unconditionally.  ``events()`` returns an
    empty list so validators and exporters degrade gracefully."""

    enabled = False

    def span(self, track, name, **args):
        return _NULL_SPAN

    def complete(self, track, name, t0, t1, **args):
        pass

    def instant(self, track, name, **args):
        pass

    def counter(self, track, name, **values):
        pass

    def flow_start(self, track, name, fid):
        pass

    def flow_end(self, track, name, fid):
        pass

    def events(self):
        return []


NULL_TRACER = NullTracer()


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tr", "_track", "_name", "_args", "_t0")

    def __init__(self, tr, track, name, args):
        self._tr = tr
        self._track = track
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = self._tr.clock.now()
        return self

    def __exit__(self, *exc):
        self._tr.complete(self._track, self._name, self._t0,
                          self._tr.clock.now(), **self._args)
        return False


class Tracer(NullTracer):
    """Recording tracer: appends :class:`Event` rows under a lock.

    ``clock`` is injectable (defaults to the process monotonic clock);
    every timestamp an engine, cluster, or allocator records through
    this tracer comes from it, so a :class:`FakeClock` makes whole
    traces deterministic.  Thread-safe: concurrent replica threads may
    record interleaved events; export sorts by timestamp."""

    enabled = True

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else MONOTONIC
        self._events: list[Event] = []
        self._lock = threading.Lock()

    def _record(self, ev: Event) -> None:
        with self._lock:
            self._events.append(ev)

    def span(self, track, name, **args):
        """Context manager: records a complete span over the ``with``
        body (host-side wall time between enter and exit)."""
        return _Span(self, track, name, args)

    def complete(self, track, name, t0, t1, **args):
        """Record a finished span ``[t0, t1]`` (explicit timestamps, for
        spans that cross call boundaries - a request's slot residency)."""
        self._record(Event("X", track, name, t0, max(t1 - t0, 0.0), args))

    def instant(self, track, name, **args):
        self._record(Event("i", track, name, self.clock.now(), 0.0, args))

    def counter(self, track, name, **values):
        """Record a counter sample (one Chrome counter track per name;
        ``values`` are the series, e.g. ``free=12, live=4``)."""
        self._record(Event("C", track, name, self.clock.now(), 0.0,
                           dict(values)))

    def flow_start(self, track, name, fid):
        """Open a flow arrow (e.g. at a preemption); ``flow_end`` with
        the same ``fid`` draws the arrow to wherever the work resumed."""
        self._record(Event("s", track, name, self.clock.now(), 0.0, {},
                           str(fid)))

    def flow_end(self, track, name, fid):
        self._record(Event("f", track, name, self.clock.now(), 0.0, {},
                           str(fid)))

    def events(self) -> list[Event]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # -- export --------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The recorded events as a Chrome trace-event JSON object
        (Perfetto-loadable).  Tracks map to threads of one process,
        named via ``thread_name`` metadata and ordered alphabetically so
        ``replicaN`` sits above its ``replicaN/slotM`` request tracks;
        timestamps are microseconds."""
        events = sorted(self.events(), key=lambda e: e.ts)
        tracks = sorted({e.track for e in events})
        tid = {t: i + 1 for i, t in enumerate(tracks)}
        out: list[dict] = []
        for t in tracks:
            out.append({"ph": "M", "pid": 1, "tid": tid[t],
                        "name": "thread_name", "args": {"name": t}})
            out.append({"ph": "M", "pid": 1, "tid": tid[t],
                        "name": "thread_sort_index",
                        "args": {"sort_index": tid[t]}})
        for e in events:
            row = {"ph": e.ph, "pid": 1, "tid": tid[e.track],
                   "name": e.name, "ts": e.ts * 1e6}
            if e.ph == "X":
                row["dur"] = e.dur * 1e6
                row["args"] = e.args
            elif e.ph == "i":
                row["s"] = "t"          # instant scope: thread
                row["args"] = e.args
            elif e.ph == "C":
                row["args"] = e.args
            elif e.ph in ("s", "f"):
                row["cat"] = "flow"
                row["id"] = e.fid
                if e.ph == "f":
                    row["bp"] = "e"     # bind to the enclosing slice
            out.append(row)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write the Chrome trace JSON to ``path``; returns the event
        count (metadata rows excluded)."""
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return sum(e["ph"] != "M" for e in trace["traceEvents"])


# ---------------------------------------------------------------------------
# Metrics registry.
# ---------------------------------------------------------------------------

def percentile(samples, q: float) -> float:
    """Nearest-rank percentile (exact over raw samples; 0.0 when empty).
    ``q`` in [0, 100]."""
    if not samples:
        return 0.0
    s = sorted(samples)
    k = max(math.ceil(q / 100.0 * len(s)), 1) - 1
    return float(s[min(k, len(s) - 1)])


class Counter:
    __slots__ = ("n", "_lock")

    def __init__(self, lock):
        self.n = 0
        self._lock = lock

    def inc(self, k: int = 1) -> None:
        with self._lock:
            self.n += k


class Gauge:
    __slots__ = ("value", "_lock")

    def __init__(self, lock):
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Raw-sample histogram: exact nearest-rank percentiles, lossless
    merge (the cluster concatenates replica samples instead of averaging
    replica summaries)."""

    __slots__ = ("samples", "_lock")

    def __init__(self, lock):
        self.samples: list[float] = []
        self._lock = lock

    def observe(self, v: float) -> None:
        with self._lock:
            self.samples.append(float(v))

    def values(self) -> list[float]:
        """Consistent copy of the raw samples (taken under the lock) —
        the safe way to read a histogram that is still being observed
        from another thread."""
        with self._lock:
            return list(self.samples)

    @property
    def count(self) -> int:
        with self._lock:
            return len(self.samples)

    @property
    def mean(self) -> float:
        s = self.values()
        return sum(s) / len(s) if s else 0.0

    def percentile(self, q: float) -> float:
        return percentile(self.values(), q)


class Timeline:
    """(time, value) series - occupancy and pool-utilization timelines."""

    __slots__ = ("points", "_lock")

    def __init__(self, lock):
        self.points: list[tuple[float, float]] = []
        self._lock = lock

    def record(self, t: float, v: float) -> None:
        with self._lock:
            self.points.append((float(t), float(v)))


class MetricsRegistry:
    """Named metric instruments, get-or-create, one lock shared by every
    instrument (serving-scale traffic; contention is not the bottleneck
    here and one lock keeps ``merge`` trivially consistent)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._timelines: dict[str, Timeline] = {}

    def _get(self, table: dict, name: str, cls):
        inst = table.get(name)
        if inst is None:
            with self._lock:
                inst = table.setdefault(name, cls(self._lock))
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    def timeline(self, name: str) -> Timeline:
        return self._get(self._timelines, name, Timeline)

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold ``other`` into this registry: counters add, histogram
        samples and timeline points concatenate (timelines re-sorted by
        time), gauges take the other's latest value.

        Safe against a *live* ``other`` (exactly what a mid-session
        metrics poll of a threaded cluster does): both registries' locks
        are held for the whole fold, acquired in a stable id-order so two
        threads cross-merging each other's registries cannot deadlock,
        and every sample list is read under them — never torn state."""
        if other is self:
            return
        first, second = sorted((self, other), key=id)
        with first._lock, second._lock:
            # mutate tables directly: the instrument methods re-acquire
            # self._lock (non-reentrant), so they must not be called here
            for name, c in other._counters.items():
                mine = self._counters.setdefault(name, Counter(self._lock))
                mine.n += c.n
            for name, h in other._histograms.items():
                mine = self._histograms.setdefault(name,
                                                   Histogram(self._lock))
                mine.samples.extend(h.samples)
            for name, t in other._timelines.items():
                mine = self._timelines.setdefault(name,
                                                  Timeline(self._lock))
                mine.points.extend(t.points)
                mine.points.sort()
            for name, g in other._gauges.items():
                mine = self._gauges.setdefault(name, Gauge(self._lock))
                mine.value = g.value

    def snapshot(self) -> dict:
        """Plain-dict view: counters/gauges verbatim, histograms as
        count/mean/p50/p90/p99, timelines as point counts (the raw
        series stay on the instruments).  The whole snapshot is copied
        out under the registry lock, so a poll taken while worker
        threads are still observing summarizes one consistent state."""
        out: dict[str, Any] = {}
        with self._lock:
            counters = {n: c.n for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            hists = {n: list(h.samples)
                     for n, h in self._histograms.items()}
            points = {n: len(t.points) for n, t in self._timelines.items()}
        out.update(counters)
        out.update(gauges)
        for name, s in hists.items():
            out[name] = {"count": len(s),
                         "mean": sum(s) / len(s) if s else 0.0,
                         "p50": percentile(s, 50), "p90": percentile(s, 90),
                         "p99": percentile(s, 99)}
        for name, n in points.items():
            out[name] = {"points": n}
        return out


# ---------------------------------------------------------------------------
# Lifecycle conformance validation (the event-stream well-formedness the
# property suite asserts over random traces).
# ---------------------------------------------------------------------------

def validate_lifecycle(events: list[Event]) -> None:
    """Assert a recorded event stream is well-formed:

    * every span has non-negative duration;
    * every request that appears was admitted, and its admission count is
      1 + its requeue count (every re-admission was a requeue);
    * a request's first decode span starts at/after its first admission;
    * every ``preempt`` is answered by a ``requeue`` or an ``abort``, and
      each preemption's flow arrow is closed by a matching flow end;
    * per request, KV block acquisitions (prefix references, lazy
      allocations, COW copies) balance releases (COW reference drops,
      the release at finish/preempt) - the event-stream mirror of the
      allocator's conservation invariant.

    Raises AssertionError naming the first violated rule.
    """
    per: dict[Any, dict] = {}

    def rec(rid):
        return per.setdefault(rid, {
            "admits": [], "decodes": [], "finishes": 0, "preempts": 0,
            "requeues": 0, "aborts": 0, "readmits": 0,
            "acquired": 0, "released": 0})

    flows: dict[str, int] = {}
    for e in events:
        assert e.dur >= 0.0, f"negative span duration: {e}"
        if e.ph in ("s", "f"):
            flows[e.fid] = flows.get(e.fid, 0) + (1 if e.ph == "s" else -1)
            continue
        rid = e.args.get("rid")
        if rid is None:
            continue
        r = rec(rid)
        if e.name == "admit":
            r["admits"].append(e.ts)
            r["readmits"] += bool(e.args.get("readmit"))
        elif e.name == "decode":
            r["decodes"].append(e.ts)
        elif e.name == "finish":
            r["finishes"] += 1
        elif e.name == "preempt":
            r["preempts"] += 1
        elif e.name == "requeue":
            r["requeues"] += 1
        elif e.name == "abort":
            r["aborts"] += 1
        elif e.name == "kv_ref":
            r["acquired"] += e.args.get("n", 0)
        elif e.name == "kv_alloc":
            r["acquired"] += e.args.get("n", 0)
        elif e.name == "kv_cow":
            r["acquired"] += e.args.get("alloc", 0)
            r["released"] += e.args.get("freed", 0)
        elif e.name == "kv_free":
            r["released"] += e.args.get("n", 0)
    for rid, r in per.items():
        assert r["admits"], f"rid={rid}: events without an admission"
        assert len(r["admits"]) == 1 + r["readmits"], (
            f"rid={rid}: {len(r['admits'])} admits but "
            f"{r['readmits']} re-admissions")
        if r["decodes"]:
            assert min(r["decodes"]) >= min(r["admits"]), (
                f"rid={rid}: decode at {min(r['decodes'])} precedes "
                f"first admit at {min(r['admits'])}")
        assert r["preempts"] == r["requeues"] + r["aborts"], (
            f"rid={rid}: {r['preempts']} preempts vs {r['requeues']} "
            f"requeues + {r['aborts']} aborts")
        assert r["finishes"] <= 1, f"rid={rid}: finished twice"
        if r["finishes"] and not r["aborts"]:
            assert r["acquired"] == r["released"], (
                f"rid={rid}: {r['acquired']} blocks acquired vs "
                f"{r['released']} released")
    for fid, bal in flows.items():
        assert bal == 0, f"flow {fid!r}: unbalanced start/finish"
