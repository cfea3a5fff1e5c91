"""Utilization attribution: roofline-joined step accounting and bottleneck
classification.  The port's counterpart of ``repro/serving/attribution.py``.

Ara2's headline numbers are cycle accounting: functional-unit utilization
per kernel, and short-vector regimes diagnosed as *issue-rate bound* (the
scalar core cannot feed the lanes) while other kernels pin the memory
system.  This module gives every serving launch that diagnosis by joining

* the engine's step timings (``repro_torch.serving.telemetry`` clocks and,
  on the card, CUDA events) and how many of the launch's ``max_batch``
  slot lanes held a live request, with
* the roofline cost layer (``repro_torch.roofline.cost``): the flops and
  bytes of each phase - the decode step, the paged prefill chunk, the dense
  prefill - counted analytically per (phase, shape) and memoized.

Each decode launch gets one **verdict**, the paper's §6 regimes:

  ``issue``   - host issue dominates the launch (the serving twin of the
                scalar core's issue-rate bound on short vectors);
  ``memory``  - device-bound with useful arithmetic intensity below the
                machine's ridge point;
  ``compute`` - device-bound above the ridge;
  ``idle``    - the launch carried no live request.

``EngineStats.fu_utilization`` - useful flops (idle lanes excluded) per
second of device-busy time over the machine's peak - is the serving analog
of the paper's FU-utilization figure; replicas record raw samples and a
cluster derives it from their merged registries.

**Host and device on this port.**  Eager PyTorch launches each kernel as
Python reaches it, so the reference's split of a step (``[t0, t_disp]``
dispatch, ``[t_disp, t1]`` blocked on the device) means something else:

* the *verdict* keeps the reference's host-clock test.  On the card the
  engine's issue time is every moment of the step the host spent on its
  own work: the decode's dispatch and the host's part of sampling
  (``engine._pick_rows`` picks rows on the host); the waits for the device
  (the read-back of the tokens, a threaded replica's stream synchronize)
  are device time.  On the CPU, where PyTorch computes each op as it is
  issued, the decode call is the device time and sampling the issue time.
  Under the cluster's threaded driver a replica also waits for the
  dispatch lock while other replicas issue; that wait is neither
  (``contention_s``, sampled as ``attr_contention_ms``) and is left out of
  both sides.
* the *busy time* ``fu_utilization`` divides by (``attr_device_ms`` for a
  decode step, ``attr_prefill_ms`` for a prefill launch) comes on the card
  from two ``torch.cuda.Event`` s on the current stream, before the
  launch's first kernel and after its last, read after a read-back the
  engine already makes (``device_span``): the step's own, the prefill's
  first token, or for a paged chunk whichever comes next.  Their span
  includes the device's idle gaps between launches, so it is at least the
  kernels' own time and ``fu_utilization`` never overstates the busy share.
  A prefill's host time is then sampled apart (``attr_prefill_issue_ms``).
  On the CPU the host clock's spans stand, as in the reference: the decode
  call's, and a prefill's ``[t0, t1]``.

Attribution adds no device sync, and no tensor the engine computes depends
on it: tokens are byte-identical with attribution on and off.  The default
:data:`NULL_ATTR` is a no-op, guarded by ``enabled`` on the hot path.
"""
from __future__ import annotations

import dataclasses
import threading

import torch

from ..roofline.cost import PhaseCost

#: Bottleneck verdicts, mapped to the paper's §6 regimes (see module doc).
VERDICTS = ("issue", "memory", "compute", "idle")

#: The issue share of a launch at or above which it is issue-bound: the
#: host spent at least as long feeding it as the device spent computing it.
ISSUE_THRESHOLD = 0.5

#: The card the port is measured on, by ``torch.cuda.get_device_name``:
#: H100 SXM, 3.35e12 B/s of HBM3, 989e12 dense bf16 FLOP/s on the tensor
#: cores and 67e12 fp32 FLOP/s on the CUDA cores (the port's fp32 runs with
#: TF32 off).
H100_SXM = "NVIDIA H100 80GB HBM3"
H100_SXM_BW = 3.35e12
H100_SXM_FLOPS = {torch.bfloat16: ("bf16", 989e12),
                  torch.float32: ("fp32", 67e12)}


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """The machine roofline attribution measures against: peak FLOP/s,
    peak memory bytes/s, and the derived ridge point (the arithmetic
    intensity where the roofline bends from the bandwidth slope onto the
    flat compute ceiling)."""
    name: str
    peak_flops: float              # FLOP/s
    mem_bw: float                  # bytes/s

    @property
    def ridge(self) -> float:
        """Ridge-point arithmetic intensity (flops per byte)."""
        return self.peak_flops / max(self.mem_bw, 1e-9)

    @classmethod
    def detect(cls, device=None, dtype=torch.bfloat16) -> "MachineSpec":
        """The spec of ``device`` (default: ``cuda`` when a card is
        present, else the CPU) for work in ``dtype``: the H100 SXM's figures
        on that card, a nominal spec on any other GPU and on the CPU, where
        absolute utilization is indicative only (verdicts and trends still
        compare run over run)."""
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        device = torch.device(device)
        if device.type != "cuda":
            return cls("cpu-nominal", 50e9, 25e9)
        if torch.cuda.get_device_name(device) == H100_SXM and \
                dtype in H100_SXM_FLOPS:
            label, flops = H100_SXM_FLOPS[dtype]
            return cls(f"h100-sxm-{label}", flops, H100_SXM_BW)
        return cls("gpu-nominal", 50e12, 1.0e12)


class DeviceSpan:
    """Two CUDA events on the current stream around a launch's kernels:
    ``stop`` after the last; ``seconds`` once the stream has passed it (a
    read-back the engine makes anyway), so timing adds no sync."""

    def __init__(self):
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        self._start.record()

    def stop(self) -> None:
        self._end.record()

    def seconds(self) -> float:
        self._end.synchronize()     # passed already, after a read-back
        return self._start.elapsed_time(self._end) / 1e3


class NullAttributor:
    """Zero-overhead default: every method is a no-op.  Hot paths guard
    on ``enabled`` (one attribute check per decode step)."""

    enabled = False

    def phase_cost(self, key, count):
        return None

    def record_step(self, metrics, tracer, track, *, t0, t_disp, t1,
                    active, width, cost, busy_s=None, contention_s=None):
        pass

    def record_prefill(self, metrics, tracer, track, *, t0, t1, cost,
                       busy_s=None):
        pass


NULL_ATTR = NullAttributor()


class Attributor(NullAttributor):
    """Recording attributor: joins step timings with phase costs.

    ``spec`` is the roofline to measure against (default:
    ``MachineSpec.detect()``).

    One Attributor may be shared by every replica of a cluster, from any
    number of threads: the cost memo is keyed by (phase, shape) and filled
    under a lock, and all recording goes into the caller's registry, which
    the cluster merges losslessly.
    """

    enabled = True

    def __init__(self, spec: MachineSpec | None = None):
        self.spec = spec if spec is not None else MachineSpec.detect()
        self._costs: dict = {}
        self._lock = threading.Lock()

    # -- cost extraction ----------------------------------------------

    def phase_cost(self, key, count) -> PhaseCost:
        """The cost ``count()`` returns (``roofline.phase_cost``), memoized
        by ``key``: a hit is a dict lookup."""
        c = self._costs.get(key)
        if c is not None:
            return c
        c = count()
        with self._lock:
            return self._costs.setdefault(key, c)

    def device_span(self, device) -> DeviceSpan | None:
        """Events around a launch on ``device``'s current stream (None off
        the card, where the host clock's span stands)."""
        return DeviceSpan() if torch.device(device).type == "cuda" else None

    # -- classification -----------------------------------------------

    def classify(self, *, active: int, width: int, dispatch_s: float,
                 device_s: float, cost: PhaseCost) -> str:
        """Bottleneck verdict for one decode launch.  ``active``/``width``
        are live vs launched slot lanes; the *useful* arithmetic intensity
        scales the phase's flops by the live fraction (idle lanes still
        drag their rows through memory), so a mostly idle launch reads
        memory-bound even when the phase's nominal intensity clears the
        ridge."""
        if active <= 0:
            return "idle"
        total = dispatch_s + device_s
        if total > 0.0 and dispatch_s >= ISSUE_THRESHOLD * total:
            return "issue"
        useful_ai = cost.ai * (active / max(width, 1))
        return "memory" if useful_ai < self.spec.ridge else "compute"

    # -- recording ----------------------------------------------------

    def record_step(self, metrics, tracer, track, *, t0, t_disp, t1,
                    active, width, cost, busy_s=None,
                    contention_s=None) -> None:
        """Attribute one decode launch: ``[t0, t_disp]`` is its issue time
        and ``[t_disp, t1]`` its device time on the host clock (the engine
        passes ``t_disp = t0 + issue``), less ``contention_s``, the seconds
        a threaded replica then waited for the dispatch lock (sampled as
        ``attr_contention_ms`` when given).  Records the verdict counter,
        raw per-step samples (useful flops, bytes, issue / device ms -
        histograms, so cluster aggregation stays lossless) and, when a
        tracer is live, a per-step ``roofline`` counter track (percent of
        peak FLOP/s and bytes/s).  ``busy_s``, when given (the card's event
        span), is the device-busy sample instead of the device time."""
        held = contention_s or 0.0
        dispatch_s = max(t_disp - t0, 0.0)
        device_s = max(t1 - t_disp - held, 0.0)
        verdict = self.classify(active=active, width=width,
                                dispatch_s=dispatch_s, device_s=device_s,
                                cost=cost)
        useful_flops = cost.flops * (active / max(width, 1))
        m = metrics
        m.counter(f"attr_verdict_{verdict}").inc()
        m.histogram("attr_step_flops").observe(useful_flops)
        m.histogram("attr_step_bytes").observe(cost.mem_bytes)
        m.histogram("attr_dispatch_ms").observe(dispatch_s * 1e3)
        m.histogram("attr_device_ms").observe(
            (device_s if busy_s is None else busy_s) * 1e3)
        if contention_s is not None:
            m.histogram("attr_contention_ms").observe(contention_s * 1e3)
        m.gauge("attr_peak_flops").set(self.spec.peak_flops)
        m.gauge("attr_peak_bytes_s").set(self.spec.mem_bw)
        m.gauge("attr_decode_ai").set(cost.ai)
        if tracer.enabled:
            step_s = max(t1 - t0 - held, 1e-12)
            tracer.counter(
                track, "roofline",
                flops_pct=100.0 * useful_flops / (step_s
                                                  * self.spec.peak_flops),
                bytes_pct=100.0 * cost.mem_bytes / (step_s
                                                    * self.spec.mem_bw))

    def record_prefill(self, metrics, tracer, track, *, t0, t1, cost,
                       busy_s=None) -> None:
        """Attribute one prefill launch (a paged chunk or a dense prefill).
        Its verdict is pure roofline, as in the reference: the phase's
        arithmetic intensity against the ridge (prefill batches whole
        prompts, the paper's long-vector regime).  ``busy_s``, when given
        (the card's event span), is the busy sample, and the host's
        ``[t0, t1]`` goes to ``attr_prefill_issue_ms``."""
        dt = max(t1 - t0, 0.0)
        verdict = "memory" if cost.ai < self.spec.ridge else "compute"
        m = metrics
        m.counter(f"attr_prefill_verdict_{verdict}").inc()
        m.histogram("attr_prefill_flops").observe(cost.flops)
        m.histogram("attr_prefill_bytes").observe(cost.mem_bytes)
        m.histogram("attr_prefill_ms").observe(
            (dt if busy_s is None else busy_s) * 1e3)
        if busy_s is not None:
            m.histogram("attr_prefill_issue_ms").observe(dt * 1e3)
        m.gauge("attr_peak_flops").set(self.spec.peak_flops)
        m.gauge("attr_peak_bytes_s").set(self.spec.mem_bw)
        if tracer.enabled:
            span_s = max(dt, 1e-12)
            tracer.counter(
                track, "roofline",
                flops_pct=100.0 * cost.flops / (span_s
                                                * self.spec.peak_flops),
                bytes_pct=100.0 * cost.mem_bytes / (span_s
                                                    * self.spec.mem_bw))


def dominant_verdict(counts: dict) -> str:
    """The verdict with the most steps ('' when nothing was recorded);
    ties break by the VERDICTS order (issue first)."""
    best, best_n = "", 0
    for v in VERDICTS:
        n = counts.get(v, 0)
        if n > best_n:
            best, best_n = v, n
    return best
