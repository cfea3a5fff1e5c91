"""Slot-based continuous-batching serving engine, dense and paged KV layouts.

The port's counterpart of ``repro/serving/engine.py``.  Two schedulers
(``mode``): ``continuous`` (the default) keeps a fixed pool of
``max_batch`` decode slots and admits a queued request into a freed slot
at once; ``lockstep`` runs requests in groups of ``max_batch`` (left-padded
batched prefill, the group decoding in step until its longest member is
done), the baseline the reference keeps beside it.

Two KV layouts (``kv_layout``):

* ``dense`` (default) - every slot owns a full ``(Hkv, cache_len, D)``
  strip per layer.  A prompt is prefilled on admission through the flash
  attention kernel and written into its slot (``model.cache_slot_write``);
  decode attends over each slot's strip up to its own position.  With
  ``bucket="pow2"`` (or an integer multiple) prompts are right-padded to
  the bucket and the true length rides in ``batch["prefill_len"]``, so
  outputs are unchanged and the number of distinct prefill shapes
  (``EngineStats.prefill_compiles``) drops to one per bucket.
* ``paged`` - one global pool of fixed-size KV blocks
  (``repro_torch.serving.kvcache.BlockAllocator``) addressed through
  per-slot block tables.  Both phases run the paged attention kernels: a
  **chunked prefill** admits a prompt in ``block_size`` chunks, each
  chunk's K/V written straight into a just-allocated pool block and its
  queries attending over the blocks written so far; decode runs one token
  for every slot per step.  Blocks are allocated lazily as a request's
  position grows and returned the moment it finishes, so admission is
  bounded by *free blocks*, and ``cache_len`` is only the per-request
  context bound (the block table's width).

Admission (``admission=``): ``reserve`` (default) promises a request's
worst case at admit time, so lazy growth never fails; ``overcommit`` admits
when one block is free, and growth that finds the pool empty raises
:class:`~repro_torch.serving.kvcache.PoolPressure` out of ``session_step``
so an outer scheduler can ``session_preempt`` a victim (its generated
prefix rides in ``Request.done``) and retry.  A re-admitted paged request
prefills its prompt in chunks and then *replays* ``done`` through the
decode step at the engine's full width (``_replay_paged``), as the
uninterrupted run computed those positions: a chunked prefill of prompt +
done is the same function in other GEMM shapes and another key split, and
on the card it rounds differently, so the resumed stream would part from
the uninterrupted one at a near-tie (the reference prefills prompt +
done).

Prefix caching (``prefix_cache=True``): full ``block_size`` spans of a
finished prefill are registered in the allocator's index under exact chain
keys; a later admission with the same prefix references the resident
blocks instead of recomputing them.  A request whose whole prefill is
covered re-runs its final chunk (its logits seed the first token) behind a
**copy-on-write** barrier (``_cow_block``).

Scan families (hybrid, ssm) serve on the dense slot layout only: a prefill
folds every position into recurrent state, so ``bucket=`` is refused, and
there is no block pool to page.  A freed slot's state is zeroed
(``model.cache_slot_reset``), and a preempted request resumes by *replay*
(``_replay_done``): the prompt is prefilled and the generated tokens are
stepped through the decode recurrence again, byte-exactly.

The reference's jitted, donated calls become direct calls that update the
cache tensors in place.  Sampling keeps the reference's request-keyed
contract (``_sample_rows``): greedy rows take the argmax, sampled rows draw
JAX's threefry streams bit for bit (``serving.sampling``).

Utilization attribution (``attribution=`` / ``set_attributor``; see
``serving.attribution``): every decode launch, dense prefill and paged
prefill chunk of the continuous scheduler is joined with its analytic cost
(``repro_torch.roofline``) into a roofline verdict and the FU-utilization
rollup of ``EngineStats``.  The lockstep scheduler is not attributed, as
in the reference, nor are a resumed paged request's replay steps (the
reference re-prefills those positions in attributed chunks).  Host-side
only: the tokens do not depend on it.

Per-request side inputs (``extra_inputs=``, the vlm's patches, the
encdec family's encoder frames): each leaf holds one row a request, taken
by submission order (``_gather_extra``; a leaf of one row broadcasts), in
the continuous admit, the lockstep group prefill and a preempted request's
re-admission alike.  A vlm prefill puts ``n_patches`` model-side
positions ahead of the tokens (``_n_prefix``): the prefill position, the
write budget, the bucket cap, the chunk feed and the paged replay count
them, and the prefix cache is refused (patch rows have no token ids to
hash).  An encdec prefill encodes its frames and keeps their cross strips
in the slot beside the decoder's self strips; the frames' length is the
cost layer's ``enc_len``.
"""
from __future__ import annotations

import collections
import dataclasses
import queue as queue_mod
import threading
from typing import Any

import numpy as np
import torch

from ..models.model import Model
from ..models.transformer import n_prefix
from ..roofline import phase_cost
from . import kvcache, sampling
from .attribution import NULL_ATTR, VERDICTS, dominant_verdict
from .kvcache import BlockAllocator, PoolPressure, blocks_needed
from .slo import make_policy
from .telemetry import MONOTONIC, NULL_TRACER, MetricsRegistry


@dataclasses.dataclass
class Request:
    """One generation request.

    Everything observable about its output is a pure function of
    (``prompt``, ``max_new_tokens``, ``temperature``, ``rid``, base key):
    the scheduler may admit, preempt and re-admit it freely.  The remaining
    fields are scheduler bookkeeping that preemption threads through a
    requeue."""
    prompt: list[int]
    max_new_tokens: int = 32       # total budget, including ``done``
    temperature: float = 0.0
    rid: int = 0
    priority: int = 0              # preemption picks the lowest first
    # tokens already generated before this (re)admission: set by
    # session_preempt when a request is re-queued; prefill covers
    # prompt + done and sampling resumes at stream index len(done)
    done: tuple = ()
    # time-to-first-token of the *first* admission, carried across
    # preemptions so Result.prefill_ms stays the request's real TTFT
    first_ttft_ms: float | None = None
    # clock time of the *first* admission, carried across preemptions that
    # fired before any token was sampled (mid-prefill eviction)
    first_admit_t: float | None = None
    # times this request has been preempted
    requeues: int = 0
    # SLO budgets (None = best-effort): enqueue -> first token, and decode
    # ms per output token.  They order scheduling, never the tokens.
    slo_ttft_ms: float | None = None
    slo_tpot_ms: float | None = None


@dataclasses.dataclass
class Result:
    """One request's output: the full generated stream (a preempted
    request's ``done`` prefix included) plus its latency split."""
    rid: int
    tokens: list[int]
    prefill_ms: float = 0.0        # time-to-first-token for this request
    decode_ms_per_tok: float = 0.0


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One streamed token, emitted the moment it is sampled.  ``index`` is
    the token's position in the request's full output stream; ``final``
    marks its last token."""
    rid: int
    token: int
    index: int
    final: bool


def _stream_events(run):
    """Drive ``run(on_token_callback)`` on a background thread, yielding
    the :class:`TokenEvent` rows it emits in order.  An exception from the
    run re-raises out of the generator after the driver thread is
    joined."""
    q: queue_mod.SimpleQueue = queue_mod.SimpleQueue()

    def driver():
        try:
            run(q.put)
            q.put(("done", None))
        except BaseException as e:      # re-raised in the consumer
            q.put(("error", e))

    t = threading.Thread(target=driver, name="stream-driver", daemon=True)
    t.start()
    while True:
        item = q.get()
        if isinstance(item, TokenEvent):
            yield item
            continue
        kind, payload = item
        t.join()
        if kind == "error":
            raise payload
        return


@dataclasses.dataclass
class EngineStats:
    """Aggregate metrics for the last ``generate`` call (or session), a
    view over a :class:`~repro_torch.serving.telemetry.MetricsRegistry`.
    ``occupancy`` is the fraction of launched decode lanes that held a live
    request; the ``*_p50/p90/p99`` fields are exact nearest-rank
    percentiles over the raw samples."""
    mode: str
    wall_s: float
    generated_tokens: int
    tokens_per_s: float
    decode_steps: int              # decode launches (cluster: summed)
    occupancy: float               # busy slot-steps / (max_batch * steps)
    ttft_ms_mean: float            # mean time-to-first-token
    kv_layout: str = "dense"
    prefill_compiles: int = 0      # distinct prefill shapes run so far
    block_util_peak: float = 0.0   # paged: peak live blocks / pool capacity
    preempted: int = 0             # requests evicted under pool pressure
    requeued: int = 0              # re-admissions of preempted requests
    router_policy: str = ""        # cluster-level: routing policy used
    prefix_hits: int = 0           # prompt blocks admitted by reference
    prefix_tokens_reused: int = 0  # prefill positions skipped via hits
    ttft_ms_p50: float = 0.0
    ttft_ms_p90: float = 0.0
    ttft_ms_p99: float = 0.0
    tpot_ms_mean: float = 0.0      # time-per-output-token (per request)
    tpot_ms_p50: float = 0.0
    tpot_ms_p90: float = 0.0
    tpot_ms_p99: float = 0.0
    queue_age_ms_mean: float = 0.0  # enqueue -> admission wait
    queue_age_ms_p99: float = 0.0
    sched_policy: str = ""
    slo_ttft_total: int = 0
    slo_ttft_attained: int = 0
    slo_tpot_total: int = 0
    slo_tpot_attained: int = 0
    slo_attainment: float = 1.0
    slo_starve_preempts: int = 0   # cluster: starvation-pressure evictions
    # -- utilization attribution (serving.attribution) --
    # All zero / empty unless an Attributor was attached.  fu_utilization:
    # useful flops (idle slot lanes excluded) per second of device-busy
    # time, over the machine's peak - the paper's FU-utilization figure.
    fu_utilization: float = 0.0
    achieved_flops_per_s: float = 0.0  # useful FLOP/s over busy time
    achieved_bytes_per_s: float = 0.0  # bytes/s over busy time
    decode_ai: float = 0.0         # decode phase flops / byte
    ridge_ai: float = 0.0          # machine ridge point (flops / byte)
    bottleneck: str = ""           # dominant decode verdict
    prefill_bottleneck: str = ""   # dominant prefill verdict
    verdict_counts: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_registry(cls, m: MetricsRegistry, *, mode: str, wall_s: float,
                      kv_layout: str = "dense", prefill_compiles: int = 0,
                      block_util_peak: float = 0.0, router_policy: str = "",
                      sched_policy: str = "") -> "EngineStats":
        """Derive the stats view from a registry (one engine session's,
        or several replicas' registries merged)."""
        ttft = m.histogram("ttft_ms")
        tpot = m.histogram("tpot_ms")
        qage = m.histogram("queue_age_ms")
        gen = m.counter("generated_tokens").n
        busy = m.counter("busy_slot_steps").n
        offered = m.counter("offered_slot_steps").n
        slo_tt = m.counter("slo_ttft_total").n
        slo_ta = m.counter("slo_ttft_attained").n
        slo_pt = m.counter("slo_tpot_total").n
        slo_pa = m.counter("slo_tpot_attained").n
        # attribution rollup over raw per-launch samples (replica
        # registries merge losslessly, so a cluster's figure comes from
        # the union exactly as a single engine's does)
        def total(name):
            return sum(m.histogram(name).values())
        busy_s = (total("attr_device_ms") + total("attr_prefill_ms")) / 1e3
        useful = total("attr_step_flops") + total("attr_prefill_flops")
        moved = total("attr_step_bytes") + total("attr_prefill_bytes")
        peak = m.gauge("attr_peak_flops").value
        mem_bw = m.gauge("attr_peak_bytes_s").value
        verdicts = {v: m.counter(f"attr_verdict_{v}").n for v in VERDICTS}
        verdicts = {k: n for k, n in verdicts.items() if n}
        pf_verdicts = {v: m.counter(f"attr_prefill_verdict_{v}").n
                       for v in VERDICTS}
        ach_f = useful / busy_s if busy_s > 0 else 0.0
        ach_b = moved / busy_s if busy_s > 0 else 0.0
        return cls(
            mode, wall_s, gen, gen / max(wall_s, 1e-9),
            m.counter("decode_steps").n, busy / max(offered, 1), ttft.mean,
            kv_layout=kv_layout, prefill_compiles=prefill_compiles,
            block_util_peak=block_util_peak,
            preempted=m.counter("preempted").n,
            requeued=m.counter("requeued").n,
            router_policy=router_policy,
            prefix_hits=m.counter("prefix_hits").n,
            prefix_tokens_reused=m.counter("prefix_tokens_reused").n,
            ttft_ms_p50=ttft.percentile(50),
            ttft_ms_p90=ttft.percentile(90),
            ttft_ms_p99=ttft.percentile(99),
            tpot_ms_mean=tpot.mean,
            tpot_ms_p50=tpot.percentile(50),
            tpot_ms_p90=tpot.percentile(90),
            tpot_ms_p99=tpot.percentile(99),
            queue_age_ms_mean=qage.mean,
            queue_age_ms_p99=qage.percentile(99),
            sched_policy=sched_policy,
            slo_ttft_total=slo_tt, slo_ttft_attained=slo_ta,
            slo_tpot_total=slo_pt, slo_tpot_attained=slo_pa,
            slo_attainment=((slo_ta + slo_pa) / (slo_tt + slo_pt)
                            if slo_tt + slo_pt else 1.0),
            slo_starve_preempts=m.counter("slo_starve_preempts").n,
            fu_utilization=ach_f / peak if peak > 0 else 0.0,
            achieved_flops_per_s=ach_f, achieved_bytes_per_s=ach_b,
            decode_ai=m.gauge("attr_decode_ai").value,
            ridge_ai=peak / mem_bw if mem_bw > 0 else 0.0,
            bottleneck=dominant_verdict(verdicts),
            prefill_bottleneck=dominant_verdict(pf_verdicts),
            verdict_counts=verdicts)


@dataclasses.dataclass
class _Slot:
    req: Request
    tag: int                       # caller's result index (``tag`` arg)
    tokens: list[int]              # tokens generated *this* admission
    ttft_ms: float
    admit_seq: int = 0             # global admission order (victim pick)
    decode_s: float = 0.0
    steps: int = 0
    prefill_pos: int = 0           # cache positions the prefill will write
    blocks: list[int] = dataclasses.field(default_factory=list)
    reserve_left: int = 0          # worst-case blocks not yet allocated
    # chunked-prefill progress: chunks completed so far, or None once the
    # prefill has finished and the first token is sampled
    chunks_done: int | None = None
    # prefix cache: blocks[:shared_until] are referenced from the prefix
    # index (refcounted, read-only for this slot until copy-on-write)
    shared_until: int = 0
    extra_row: int = 0             # extra_inputs row (vlm patches)
    replayed: int = 0              # paged: ``done`` tokens replayed so far
    admit_t: float = 0.0           # clock time of the *first* admission
    enqueue_t: float | None = None  # clock time the request was queued
    span_t0: float = 0.0           # clock time of *this* admission
    first_tok_t: float = 0.0       # clock time of this admission's first
    #                                sampled token (decode-stretch start)


@dataclasses.dataclass
class _Session:
    """Mutable state of one stepwise continuous-batching run; all scalar
    accounting and latency samples live in ``metrics``."""
    key: Any                       # base key (two uint32 words)
    slots: list
    toks: np.ndarray               # (B, 1) next-token feed
    temps: np.ndarray              # (B,) per-slot temperature
    rids: np.ndarray               # (B,) per-slot request id
    tok_idx: np.ndarray            # (B,) next sample's stream index
    metrics: MetricsRegistry
    t_start: float
    cache: Any = None
    admit_counter: int = 0
    # Results finished during session_step's prefill phase, parked so they
    # survive a PoolPressure raised later in the same step
    finished_pending: list = dataclasses.field(default_factory=list)
    on_token: Any = None
    # paged chunks attributed on the card, waiting for a read-back to pass
    # their device spans: (track, t0, t1, cost, span)
    attr_pending: list = dataclasses.field(default_factory=list)


def _sample_rows(logits, temps, key, rids, tok_idx) -> np.ndarray:
    """``_pick_rows``'s B tokens read back to the host (the read waits for
    the device)."""
    return _pick_rows(logits, temps, key, rids, tok_idx).cpu().numpy()


def _pick_rows(logits, temps, key, rids, tok_idx) -> torch.Tensor:
    """Per-row temperature sampling over (B, V) logits, request-keyed as in
    the reference: row ``i`` draws with ``fold_in(fold_in(key, rids[i]),
    tok_idx[i])``, so a stream depends only on (key, rid, token index) -
    never on slot, step order or batch.  Greedy rows (temperature <= 0)
    take the argmax, the first index on ties as ``jnp.argmax`` does;
    sampled rows draw ``categorical(logits / temperature)`` on JAX's
    threefry streams (``serving.sampling``).  ``temps``, ``rids`` and
    ``tok_idx`` are host arrays of B entries; returns the B tokens on the
    logits' device, launched without a sync."""
    out = torch.argmax(logits, dim=-1)
    hot = np.flatnonzero(np.asarray(temps) > 0.0)
    if hot.size:
        dev = logits.device

        def rows(a, dtype):
            return torch.from_numpy(np.asarray(a)[hot].astype(dtype)).to(dev)
        keys = sampling.fold_in(sampling.fold_in(key, rows(rids, np.int64)),
                                rows(tok_idx, np.int64))
        safe = torch.clamp_min(rows(temps, np.float32), 1e-6)[:, None]
        idx = torch.from_numpy(hot).to(dev)
        out[idx] = sampling.categorical(keys, logits[idx] / safe)
    return out


class ServeEngine:
    """Batched generation over the port's ``Model`` API.

    Invariants (asserted port against port in ``tests/test_torch_*``):
    tokens are independent of layout, scheduler, slot, step order,
    preemption and prefix-cache hits (sampled rows are request-keyed);
    after ``generate`` returns or raises, every block and reservation is
    back in the pool.

    mode: "auto" (continuous), "continuous" or "lockstep" (dense only).
    kv_layout: "dense" (default) or "paged" (continuous only).
    bucket: None (exact-length dense prefills), "pow2", or an integer
    pad-to-multiple.  block_size / n_blocks size the paged pool (n_blocks
    defaults to ``max_batch * cache_len`` positions plus the null block);
    ``allocator=`` injects an external pool, ``owner=`` tags this engine's
    allocations in it, ``admission=`` is "reserve" or "overcommit"
    (paged); ``prefix_cache`` is paged only.
    ``policy`` names a scheduling policy of ``serving.slo.POLICIES``.
    ``tracer`` / ``clock`` / ``track``: telemetry, host-side only.
    ``attribution``: a ``serving.attribution.Attributor`` (host-side).
    ``extra_inputs`` (vlm patches): a dict of tensors with one row a
    request, indexed by submission order; a leaf of one row broadcasts to
    every request, and too few rows is an error, not a clamp.
    The device is the parameters' device.
    """

    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 cache_len: int = 1024, mode: str = "auto",
                 kv_layout: str = "dense", block_size: int | None = None,
                 n_blocks: int | None = None, bucket=None,
                 allocator: BlockAllocator | None = None,
                 admission: str = "reserve", owner: Any = 0,
                 prefix_cache: bool = False, policy="fifo",
                 tracer=None, clock=None, track: str | None = None,
                 attribution=None, extra_inputs: dict | None = None):
        if mode not in ("auto", "continuous", "lockstep"):
            raise ValueError(f"mode={mode!r}: expected auto, continuous or "
                             "lockstep")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout={kv_layout!r}: expected dense or "
                             "paged")
        if admission not in ("reserve", "overcommit"):
            raise ValueError(f"admission={admission!r}: expected reserve "
                             "or overcommit")
        if bucket is not None and bucket != "pow2" and (
                isinstance(bucket, bool) or not isinstance(bucket, int)
                or bucket < 1):
            raise ValueError(f"bucket={bucket!r}: expected None, 'pow2' or "
                             "a positive integer")
        if bucket and not model.supports_prefill_len:
            raise ValueError(
                f"bucket={bucket!r}: family {model.cfg.family!r} prefill "
                "cannot mask right-pads (recurrent state would absorb "
                "them); drop bucket= for scan families")
        mode = "continuous" if mode == "auto" else mode
        if kv_layout == "paged" and model.decode_paged is None:
            raise ValueError(f"kv_layout='paged': family "
                             f"{model.cfg.family!r} has no paged cache hooks")
        if kv_layout == "paged" and mode != "continuous":
            raise ValueError(
                "kv_layout='paged' requires the continuous scheduler")
        if kv_layout == "dense":
            if allocator is not None:
                raise ValueError("allocator= requires kv_layout='paged'")
            if admission != "reserve":
                raise ValueError("admission='overcommit' requires "
                                 "kv_layout='paged'")
            if prefix_cache:
                raise ValueError("prefix_cache=True requires kv_layout="
                                 "'paged' (there are no blocks to share)")
        if prefix_cache and model.cfg.family == "vlm":
            raise ValueError(
                "prefix_cache=True: vlm prompts start with a patch prefix "
                "whose content is not addressable by token ids, so prefix "
                "blocks cannot be content-hashed")
        self.model = model
        self.params = params
        self.device = params["embed"]["embedding"].device
        self.extra = {k: torch.as_tensor(v).to(self.device)
                      for k, v in (extra_inputs or {}).items()}
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.owner = owner
        self.tracer = NULL_TRACER
        self.attr = NULL_ATTR
        self.clock = MONOTONIC
        self.track = track if track is not None else f"engine{owner}"
        self.last_metrics = MetricsRegistry()
        self.mode = mode
        self.kv_layout = kv_layout
        self.bucket = bucket
        self.policy = make_policy(policy)
        self._admission = admission
        self.prefix_cache = prefix_cache
        self.last_stats: EngineStats | None = None
        self._sess: _Session | None = None
        self._prefill_shapes: set[int] = set()   # prefill lengths run
        self._owns_pool = False
        # called just before a step's sampled tokens are read back to the
        # host (the read waits for the device): the cluster's threaded
        # driver lets other replicas dispatch meanwhile
        self.await_device = None
        if kv_layout == "paged":
            self._init_pool(allocator, block_size, n_blocks, admission)
        self._decode = (model.decode_paged if kv_layout == "paged"
                        else model.decode)
        if tracer is not None:
            self.set_tracer(tracer)
        if clock is not None:
            self.clock = clock
        if attribution is not None:
            self.set_attributor(attribution)

    def _init_pool(self, allocator, block_size, n_blocks, admission) -> None:
        """The paged layout's block pool: an owned one sized here, or an
        external (shared) ``allocator``."""
        if allocator is not None:
            if n_blocks is not None:
                raise ValueError("n_blocks conflicts with an external "
                                 "allocator (the pool is already sized)")
            if block_size is not None and block_size != allocator.block_size:
                raise ValueError(
                    f"block_size={block_size} conflicts with the external "
                    f"allocator's {allocator.block_size}")
            block_size = allocator.block_size
        else:
            self._owns_pool = True
            if block_size is None:
                block_size = 16
        self.block_size = block_size
        self.max_blocks = blocks_needed(self.cache_len, block_size)
        if allocator is None:
            if n_blocks is None:
                n_blocks = self.max_batch * self.max_blocks + 1
            allocator = BlockAllocator(n_blocks, block_size)
        allocator.claim_policy(admission)
        self.allocator = allocator
        # device pool kept across sessions (prefix_cache only): cached
        # blocks' bytes must stay resident to be hit again
        self._pcache = None

    # ------------------------------------------------------------------
    # Telemetry plumbing.
    # ------------------------------------------------------------------

    def set_tracer(self, tracer, track: str | None = None) -> None:
        """Attach (or detach, with None) a tracer.  The engine adopts an
        enabled tracer's clock; an owned pool's allocator follows it."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if track is not None:
            self.track = track
        if self.tracer.enabled:
            self.clock = self.tracer.clock
        if self._owns_pool:
            self.allocator.set_tracer(self.tracer)

    def set_attributor(self, attributor) -> None:
        """Attach (or detach, with None) a utilization attributor
        (``serving.attribution.Attributor``).  Host-side only: no tensor the
        engine computes depends on it, so tokens are byte-identical with
        attribution on and off.  It covers the continuous scheduler's
        decode launches, dense prefills and paged prefill chunks; one
        attributor may be shared across a cluster's replicas (its cost
        memo is shape-keyed)."""
        self.attr = attributor if attributor is not None else NULL_ATTR

    def _phase_cost(self, key: tuple):
        """The memoized cost of the phase ``key`` names at this engine's
        shapes (``roofline.phase_cost``)."""
        frames = self.extra.get("frames")
        return self.attr.phase_cost(key, lambda: phase_cost(
            self.model.cfg, key, cache_len=self.cache_len,
            block_size=getattr(self, "block_size", None),
            dtype=self.params["embed"]["embedding"].dtype,
            enc_len=None if frames is None else frames.shape[1]))

    def _slot_track(self, i: int) -> str:
        return f"{self.track}/slot{i}"

    # ------------------------------------------------------------------
    # Public API.
    # ------------------------------------------------------------------

    def generate(self, requests: list[Request], key=None,
                 on_token=None) -> list[Result]:
        """Run ``requests`` to completion and return their Results.
        ``on_token`` streams every sampled token as a :class:`TokenEvent`
        the moment it exists (continuous mode only).  ``key``: the base
        key of sampled rows, two uint32 words (None: seed 0)."""
        key = sampling.as_key(key)
        requests = list(requests)
        todo = [(i, r) for i, r in enumerate(requests)
                if r.max_new_tokens - len(r.done) > 0]
        if not todo:
            self.last_metrics = MetricsRegistry()
            self.last_stats = EngineStats(
                self.mode, 0.0, 0, 0.0, 0, 0.0, 0.0,
                kv_layout=self.kv_layout,
                prefill_compiles=len(self._prefill_shapes))
            return [Result(r.rid, list(r.done)) for r in requests]
        if self.kv_layout == "paged":
            # reject impossible requests before any work is scheduled: a
            # raise mid-schedule would abort the batch with blocks held
            for _, r in todo:
                self.check_request(r)
        if self.mode == "continuous":
            done = self._generate_continuous(todo, key, on_token)
        else:
            if on_token is not None:
                raise ValueError("streaming (on_token) requires the "
                                 "continuous scheduler")
            done = self._generate_lockstep(todo, key)
        results = [Result(r.rid, list(r.done)) for r in requests]
        for (i, _), res in zip(todo, done):
            results[i] = res
        return results

    def check_request(self, r: Request) -> None:
        """Reject a request that can never be served: context overflow, or
        (paged) a worst case larger than the whole pool."""
        self._check_budget(self._n_prefix() + len(r.prompt) + len(r.done),
                           r.max_new_tokens - len(r.done), r.rid)
        if self.kv_layout != "paged":
            return
        worst = self._worst_blocks(r)
        if worst > self.allocator.capacity:
            raise ValueError(
                f"request rid={r.rid} needs {worst} KV blocks "
                f"(block_size={self.block_size}) but the pool only has "
                f"{self.allocator.capacity}")

    # ------------------------------------------------------------------
    # Admission accounting helpers.
    # ------------------------------------------------------------------

    def _check_budget(self, prefill_pos: int, max_new: int, rid) -> None:
        """Every position written past prefill must fit ``cache_len``: the
        per-slot strip length (dense) or the block table's width (paged).
        A family whose state is unbounded in context (``model.bounded_cache``
        False: the scan families' recurrent state, hybrid's wrapping ring)
        has no budget."""
        if not self.model.bounded_cache:
            return
        writes = prefill_pos + max(max_new - 1, 0)
        if writes > self.cache_len:
            raise ValueError(
                f"request rid={rid} needs {writes} cache positions "
                f"(prefill {prefill_pos} + {max_new - 1} decode writes) "
                f"but cache_len={self.cache_len}")

    def _gather_extra(self, rows: list[int]) -> dict:
        """The ``extra_inputs`` rows of the requests submitted ``rows``-th
        (a leaf of one row broadcasts)."""
        out = {}
        for k, v in self.extra.items():
            if v.shape[0] == 1:
                out[k] = v.expand((len(rows),) + tuple(v.shape[1:]))
            elif max(rows) < v.shape[0]:
                out[k] = v[list(rows)]
            else:
                raise ValueError(
                    f"extra_inputs[{k!r}] has {v.shape[0]} rows but request "
                    f"#{max(rows)} needs its own (pass one row per request, "
                    "or a single row to broadcast)")
        return out

    def _n_prefix(self) -> int:
        """Model-side prefix positions a prefill puts ahead of the tokens
        (the vlm's patches)."""
        return n_prefix(self.model.cfg)

    def _bucket_len(self, n: int) -> int:
        """Round a prompt length up to its bucket (pow2 or pad-to-multiple),
        capped so the padded sequence (and any model-side prefix) still
        fits the per-request bound."""
        if not self.bucket:
            return n
        if self.bucket == "pow2":
            b = 1
            while b < n:
                b <<= 1
        else:
            b = -(-n // self.bucket) * self.bucket
        return max(min(b, self.cache_len - self._n_prefix()), n)

    def _worst_blocks(self, r: Request) -> int:
        """Worst-case block count for a request (all cache positions it can
        ever write), computable before prefill runs."""
        writes = (self._n_prefix() + len(r.prompt) + len(r.done)
                  + max(r.max_new_tokens - len(r.done) - 1, 0))
        return blocks_needed(writes, self.block_size)

    def _prefill_seq(self, r: Request) -> list:
        """The tokens a paged admission prefills in chunks: the prompt (a
        re-admission's ``done`` is replayed through decode instead)."""
        return list(r.prompt)

    def _prefix_hits(self, r: Request) -> tuple[list, bool]:
        """The longest run of resident full prefix blocks of the request's
        chunked prefill (its prompt), as ``([(chain_key, block_id), ...],
        full_boundary)``; a full boundary needs the final chunk re-run for
        its logits unless ``done`` is replayed after it.  Pure: no refcount
        moves until admission."""
        if not self.prefix_cache:
            return [], False
        seq = self._prefill_seq(r)
        hits = []
        for key in kvcache.prefix_chain_keys(seq, self.block_size):
            blk = self.allocator.lookup(key, self.owner)
            if blk is None:
                break
            hits.append((key, blk))
        boundary = (bool(hits) and not r.done
                    and len(hits) * self.block_size == len(seq))
        return hits, boundary

    def _admit_block_need(self, r: Request) -> int:
        """Blocks a reserve admission must find unreserved-free: the worst
        case minus blocks admitted by reference, plus one for the
        full-boundary COW copy, plus one per cached block a hit revives."""
        hits, boundary = self._prefix_hits(r)
        n_cached = sum(self.allocator.is_cached(b) for _, b in hits)
        return (self._worst_blocks(r) - len(hits) + int(boundary)
                + n_cached)

    # ------------------------------------------------------------------
    # Stepwise session API.  All session mutators of one engine must be
    # driven from one thread at a time; only the allocator (its own lock)
    # and the tracer (locked) may be shared across threads.
    # ------------------------------------------------------------------

    def begin_session(self, key=None, on_token=None) -> None:
        """Open a stepwise session; ``on_token`` streams every sampled
        token as a :class:`TokenEvent`."""
        if self.mode != "continuous":
            raise ValueError("stepwise sessions require the continuous "
                             "scheduler")
        if self._sess is not None:
            raise RuntimeError("a session is already open on this engine")
        bsz = self.max_batch
        if self._owns_pool:
            self.allocator.reset_peak()
        self._sess = _Session(
            key=sampling.as_key(key),
            slots=[None] * bsz,
            toks=np.zeros((bsz, 1), np.int32),
            temps=np.zeros((bsz,), np.float32),
            rids=np.zeros((bsz,), np.int32),
            tok_idx=np.zeros((bsz,), np.int32),
            metrics=MetricsRegistry(), t_start=self.clock.now(),
            on_token=on_token)

    def _require_session(self) -> _Session:
        if self._sess is None:
            raise RuntimeError("no session is open on this engine "
                               "(call begin_session first)")
        return self._sess

    @property
    def session_active(self) -> int:
        """Busy slot count of the open session (0 when none is open)."""
        if self._sess is None:
            return 0
        return sum(s is not None for s in self._sess.slots)

    def session_free_slot(self) -> int | None:
        for i, s in enumerate(self._sess.slots):
            if s is None:
                return i
        return None

    def session_slots(self):
        """Live (slot index, slot) pairs - victim scanning."""
        return [(i, s) for i, s in enumerate(self._sess.slots)
                if s is not None]

    def session_victims(self, now: float):
        """Policy-ranked preemption candidates ``(victim_key, slot)``; the
        minimum key is the preferred victim."""
        return [(self.policy.victim_key(s.req, s.admit_seq, s.admit_t,
                                        now), i)
                for i, s in self.session_slots()]

    def session_backlog(self) -> int:
        """Outstanding decode tokens across live slots."""
        return sum(s.req.max_new_tokens - len(s.req.done) - len(s.tokens)
                   for _, s in self.session_slots())

    def session_slot_steps(self) -> tuple[int, int]:
        """(busy, offered) slot-steps of the open session - offered counts
        max_batch lanes per launched decode step (cluster occupancy)."""
        m = self._require_session().metrics
        return (m.counter("busy_slot_steps").n,
                m.counter("offered_slot_steps").n)

    def session_can_admit(self, r: Request) -> bool:
        """Pool-side admission test (always true for the dense layout,
        whose slots own their strips).  reserve: the pool must cover the
        request's worst case on top of standing reservations.  overcommit:
        one block must be free (later growth may raise PoolPressure)."""
        if self.kv_layout != "paged":
            return True
        if self._admission == "overcommit":
            return self.allocator.n_avail >= 1
        return self.allocator.n_avail >= self._admit_block_need(r)

    def _emit_token(self, sess: _Session, r: Request, tok: int,
                    index: int) -> None:
        if sess.on_token is not None:
            sess.on_token(TokenEvent(r.rid, tok, index,
                                     index + 1 >= r.max_new_tokens))

    def _observe_slo_ttft(self, r: Request, slot: int, enqueue_t,
                          admit_t: float, t1: float) -> None:
        """Score the first token of a TTFT-budgeted request against its
        deadline (base: enqueue time, or the first admission of a
        requeued mid-prefill victim)."""
        base = r.first_admit_t
        if base is None:
            base = enqueue_t if enqueue_t is not None else admit_t
        att_ms = (t1 - base) * 1e3
        m = self._sess.metrics
        m.counter("slo_ttft_total").inc()
        m.histogram("slo_ttft_slack_ms").observe(r.slo_ttft_ms - att_ms)
        if att_ms <= r.slo_ttft_ms:
            m.counter("slo_ttft_attained").inc()
        elif self.tracer.enabled:
            self.tracer.complete(self._slot_track(slot), "slo_miss",
                                 base + r.slo_ttft_ms / 1e3, t1,
                                 rid=r.rid, phase="ttft",
                                 over_ms=att_ms - r.slo_ttft_ms)

    def _observe_slo_tpot(self, s: _Slot, per_tok_ms: float) -> None:
        m = self._sess.metrics
        m.counter("slo_tpot_total").inc()
        m.histogram("slo_tpot_slack_ms").observe(
            s.req.slo_tpot_ms - per_tok_ms)
        if per_tok_ms <= s.req.slo_tpot_ms:
            m.counter("slo_tpot_attained").inc()
        elif self.tracer.enabled:
            self.tracer.instant(self.track, "slo_miss", rid=s.req.rid,
                                phase="tpot",
                                over_ms=per_tok_ms - s.req.slo_tpot_ms)

    def session_admit(self, r: Request, tag: int, extra_row: int = 0,
                      admit_seq: int | None = None,
                      enqueue_t: float | None = None) -> Result | None:
        """Admit ``r`` into the first free slot.

        dense: the prefill runs here (prefill-on-admit) and the first token
        is sampled; returns the finished Result when the token budget is
        satisfied by the admission itself, else None.

        paged: admission installs the request and (under reserve) promises
        its worst case; the prefill itself runs chunk by chunk inside
        ``session_step``, allocating each chunk's block lazily.  Returns
        None; budget-satisfied-by-prefill Results arrive from
        ``session_step``.

        ``tag`` is echoed back with the Result; ``extra_row`` indexes
        ``extra_inputs``; ``admit_seq`` orders admissions for victim
        selection; ``enqueue_t`` is the clock time the request was
        queued."""
        sess = self._require_session()
        slot = self.session_free_slot()
        if slot is None:
            raise RuntimeError("session_admit with no free slot")
        if admit_seq is None:
            admit_seq = sess.admit_counter
        sess.admit_counter = max(sess.admit_counter, admit_seq) + 1
        t0 = self.clock.now()
        if enqueue_t is not None:
            sess.metrics.histogram("queue_age_ms").observe(
                (t0 - enqueue_t) * 1e3)
        prefill_pos = self._n_prefix() + len(r.prompt) + len(r.done)
        self._check_budget(prefill_pos, r.max_new_tokens - len(r.done),
                           r.rid)
        if self.kv_layout != "paged":
            return self._admit_dense(sess, r, tag, slot, admit_seq, t0,
                                     enqueue_t, extra_row)
        if sess.cache is None:
            if self._pcache is not None:
                # prefix cache: the previous session's pool is revived so
                # cached blocks' bytes are still resident
                sess.cache, self._pcache = self._pcache, None
            else:
                sess.cache = self.model.paged_cache_init(
                    batch=self.max_batch, n_blocks=self.allocator.n_blocks,
                    block_size=self.block_size, max_blocks=self.max_blocks,
                    dtype=self.model.cache_dtype(self.params),
                    device=self.device)
        # resolve + charge the pool atomically against co-tenant engines
        with self.allocator.lock:
            hits, boundary = self._prefix_hits(r)
            reserve_left = 0
            if self._admission == "reserve":
                reserve_left = (self._worst_blocks(r) - len(hits)
                                + int(boundary))
                n_cached = sum(self.allocator.is_cached(b)
                               for _, b in hits)
                self.allocator.reserve(reserve_left + n_cached)
            taken: list[int] = []
            for _, blk in hits:
                if self.allocator.is_cached(blk):
                    self.allocator.take_cached(
                        blk, self.owner,
                        from_reservation=self._admission == "reserve")
                else:
                    self.allocator.incref(blk, self.owner)
                taken.append(blk)
        for idx, blk in enumerate(taken):
            kvcache.bt_set_entry(sess.cache, slot, idx, blk)
        h = len(taken)
        # a fully-covered prefill still re-runs its final chunk (its
        # logits seed the first token) behind the COW barrier
        chunks_done = h - 1 if boundary else h
        sess.metrics.counter("prefix_hits").inc(h)
        sess.metrics.counter("prefix_tokens_reused").inc(
            chunks_done * self.block_size)
        if r.done or r.requeues:
            sess.metrics.counter("requeued").inc()
        tr = self.tracer
        if tr.enabled:
            st = self._slot_track(slot)
            tr.instant(st, "admit", rid=r.rid, slot=slot,
                       readmit=bool(r.done or r.requeues), prefix_hits=h,
                       prefix_tokens=chunks_done * self.block_size)
            if h:
                tr.instant("pool", "kv_ref", rid=r.rid, n=h)
            if r.requeues:
                tr.flow_end(st, "preempt_flow",
                            f"preempt-{r.rid}-{r.requeues}")
        sess.slots[slot] = _Slot(
            req=r, tag=tag, tokens=[], ttft_ms=0.0, admit_seq=admit_seq,
            prefill_pos=prefill_pos, reserve_left=reserve_left,
            blocks=taken, shared_until=h, chunks_done=chunks_done,
            extra_row=extra_row,
            admit_t=(r.first_admit_t if r.first_admit_t is not None
                     else t0), enqueue_t=enqueue_t, span_t0=t0)
        sess.temps[slot] = r.temperature
        sess.rids[slot] = r.rid
        return None

    def _await_device(self) -> tuple[float, float]:
        """Let the cluster's threaded driver run other replicas while this
        one's device works (a step's launches, sampling's included, are
        issued by then); returns the seconds it waited on the device and
        those it then waited for the driver's dispatch lock ((0.0, 0.0)
        with no driver hook: the token read-back waits instead)."""
        if self.await_device is not None:
            return self.await_device()
        return 0.0, 0.0

    def _flush_attr(self, sess: _Session) -> None:
        """Record the paged chunks whose device spans a read-back has
        passed since they were launched (``_advance_prefill``)."""
        for track, t0, t1, cost, span in sess.attr_pending:
            self.attr.record_prefill(sess.metrics, self.tracer, track,
                                     t0=t0, t1=t1, cost=cost,
                                     busy_s=span.seconds())
        sess.attr_pending.clear()

    def _replay_done(self, sub, done):
        """Rebuild a preempted scan-family request's state from its
        prompt-only prefill cache ``sub`` by feeding each ``done`` token
        through the decode step, as the uninterrupted run did: a prefill of
        prompt + done is the same function in another summation order, and
        would perturb the resumed stream.  The replay pool is as wide as the
        engine's (the request in slot 0, the other rows idle), so every
        call has the shapes the uninterrupted run's decode had: on the card
        a kernel's summation order may follow its shapes.  Returns (the
        logits for stream index ``len(done)``, a batch-1 view of the
        replayed cache for ``cache_slot_write``)."""
        mini = self.model.cache_slot_write(
            self.model.cache_expand(sub, self.max_batch), sub, 0)
        feed = torch.zeros((self.max_batch, 1), dtype=torch.int32,
                           device=self.device)
        logits = None
        for t in done:
            feed[0, 0] = t
            logits, mini = self.model.decode(self.params, mini, feed)
        return logits[:1], dict(mini, pos=mini["pos"][:1])

    def _admit_dense(self, sess: _Session, r: Request, tag: int, slot: int,
                     admit_seq: int, t0: float, enqueue_t: float | None,
                     extra_row: int) -> Result | None:
        """Prefill ``r`` into dense slot ``slot`` and sample its first token.
        KV families prefill prompt + done in one pass (re-admitting
        byte-exactly); scan families prefill the prompt and replay ``done``
        (``_replay_done``).  With ``bucket`` the prompt is right-padded to
        its bucket and the true length rides in ``prefill_len``; the
        request's ``extra_inputs`` row rides in the batch."""
        tr = self.tracer
        if tr.enabled:
            tr.instant(self._slot_track(slot), "admit", rid=r.rid,
                       slot=slot, readmit=bool(r.done or r.requeues),
                       prefix_hits=0, prefix_tokens=0)
            if r.requeues:
                tr.flow_end(self._slot_track(slot), "preempt_flow",
                            f"preempt-{r.rid}-{r.requeues}")
        replay = bool(r.done) and self.model.cache_slot_reset is not None
        seq = list(r.prompt) + ([] if replay else list(r.done))
        plen = len(seq)
        toks = np.zeros((1, self._bucket_len(plen)), np.int32)
        toks[0, :plen] = seq
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 **self._gather_extra([extra_row])}
        if self.bucket:
            batch["prefill_len"] = torch.tensor([plen], dtype=torch.int32,
                                                device=self.device)
        self._prefill_shapes.add(toks.shape[1])
        at = self.attr
        span = at.device_span(self.device) if at.enabled else None
        logits, sub = self.model.prefill(self.params, batch,
                                         cache_len=self.cache_len)
        if replay:
            logits, sub = self._replay_done(sub, r.done)
            sess.metrics.counter("resume_replay_tokens").inc(len(r.done))
        if sess.cache is None:
            sess.cache = self.model.cache_expand(sub, self.max_batch)
        sess.cache = self.model.cache_slot_write(sess.cache, sub, slot)
        # the request's t-th token always uses stream index t, so a
        # re-admitted (preempted) request resumes its stream at len(done)
        if span is not None:
            span.stop()
        self._await_device()
        tok = int(_sample_rows(logits, np.asarray([r.temperature],
                                                  np.float32),
                               sess.key, np.asarray([r.rid]),
                               np.asarray([len(r.done)]))[0])
        t1 = self.clock.now()
        ttft_ms = (t1 - t0) * 1e3
        if tr.enabled:
            tr.complete(self._slot_track(slot), "prefill", t0, t1,
                        rid=r.rid, tokens=plen)
        if at.enabled:
            self._flush_attr(sess)
            at.record_prefill(
                sess.metrics, tr, self._slot_track(slot), t0=t0, t1=t1,
                cost=self._phase_cost(("prefill", self.model.cfg.name,
                                       toks.shape[1])),
                busy_s=None if span is None else span.seconds())
        if r.done or r.requeues:
            sess.metrics.counter("requeued").inc()
        if not r.done:
            sess.metrics.histogram("ttft_ms").observe(ttft_ms)
            if r.slo_ttft_ms is not None:
                self._observe_slo_ttft(r, slot, enqueue_t, t0, t1)
        if r.first_ttft_ms is not None:
            ttft_ms = r.first_ttft_ms   # re-admission: keep the real TTFT
        self._emit_token(sess, r, tok, len(r.done))
        s = _Slot(req=r, tag=tag, tokens=[tok], ttft_ms=ttft_ms,
                  admit_seq=admit_seq,
                  prefill_pos=self._n_prefix() + len(r.prompt) + len(r.done),
                  extra_row=extra_row, admit_t=t0,
                  enqueue_t=enqueue_t, span_t0=t0, first_tok_t=t1)
        if len(r.done) + 1 >= r.max_new_tokens:
            res = self._finish(s)       # satisfied by prefill alone
            self._release(s, slot)
            if tr.enabled:
                self._trace_finish(s, slot, self.clock.now())
            return res
        sess.slots[slot] = s
        sess.toks[slot, 0] = tok
        sess.temps[slot] = r.temperature
        sess.rids[slot] = r.rid
        sess.tok_idx[slot] = len(r.done) + 1
        return None

    def session_step(self) -> list[tuple[int, Result]]:
        """One scheduler step: finish any pending chunked prefills (paged),
        then one decode launch over the slot pool.  Returns the (tag, Result)
        pairs that finished this step.  Under overcommit, raises
        PoolPressure when lazy block growth finds the pool empty; the call
        can be retried after the caller frees blocks, and resumes a
        half-prefilled slot at its next chunk."""
        sess = self._require_session()
        bsz = self.max_batch
        paged = self.kv_layout == "paged"
        for i in range(bsz) if paged else ():
            s = sess.slots[i]
            if s is not None and s.chunks_done is not None:
                res = self._advance_prefill(sess, i, s)
                if res is not None:     # satisfied by prefill alone
                    sess.finished_pending.append((s.tag, res))
                    self._release(s, i)
                    sess.slots[i] = None
                    if self.tracer.enabled:
                        self._trace_finish(s, i, self.clock.now())
        active = [i for i in range(bsz) if sess.slots[i] is not None]
        # lazy growth: each slot's next write position needs a block
        for i in active if paged else ():
            s = sess.slots[i]
            pos = s.prefill_pos + s.steps
            while len(s.blocks) * self.block_size <= pos:
                self._grow_slot(sess, i, s)
        # past the last allocation: nothing below raises PoolPressure
        finished, sess.finished_pending = sess.finished_pending, []
        if not active:
            return finished
        # one decode step over the whole slot pool (idle rows compute too:
        # dense idle rows are masked by their pos and rewritten on the next
        # admission; paged ones write into the null block, never read)
        tr = self.tracer
        at = self.attr
        t0 = self.clock.now()
        span = at.device_span(self.device) if at.enabled else None
        toks = torch.from_numpy(sess.toks).to(self.device)
        logits, sess.cache = self._decode(self.params, sess.cache, toks)
        # [t0, t_disp] is host dispatch; the read-back below waits for the
        # device, so [t_disp, t1] is device time + sampling + transfer
        t_disp = self.clock.now()
        picked = _pick_rows(logits, sess.temps, sess.key, sess.rids,
                            sess.tok_idx)
        if span is not None:
            span.stop()
        waited, contended = self._await_device()
        t_wait = self.clock.now() if at.enabled else 0.0
        nxt = picked.cpu().numpy()
        t1 = self.clock.now()
        dt = t1 - t0
        m = sess.metrics
        m.counter("decode_steps").inc()
        m.counter("busy_slot_steps").inc(len(active))
        m.counter("offered_slot_steps").inc(bsz)
        m.timeline("occupancy").record(t1, len(active) / bsz)
        if paged:
            m.timeline("pool_util").record(
                t1, self.allocator.n_live / max(self.allocator.capacity, 1))
        if tr.enabled:
            tr.complete(self.track, "step", t0, t1, active=len(active))
            tr.complete(self.track, "dispatch", t0, t_disp)
            tr.complete(self.track, "device", t_disp, t1)
        if at.enabled:
            # issue time: on the card every moment of the host's own work
            # (not the waits for the device: the driver's stream wait and
            # the read-back); on the CPU, which computes the decode as it
            # is issued, sampling.  Neither holds the wait for the
            # threaded driver's dispatch lock (``contention_s``).
            issue = (t1 - t_disp if span is None
                     else t_wait - t0 - waited) - contended
            self._flush_attr(sess)
            at.record_step(
                m, tr, self.track, t0=t0, t_disp=t0 + issue, t1=t1,
                active=len(active), width=bsz,
                cost=self._phase_cost(("decode", self.kv_layout,
                                       self.model.cfg.name, bsz)),
                busy_s=None if span is None else span.seconds(),
                contention_s=(None if self.await_device is None
                              else contended))
        for i in active:
            s = sess.slots[i]
            s.tokens.append(int(nxt[i]))
            self._emit_token(sess, s.req, int(nxt[i]),
                             len(s.req.done) + len(s.tokens) - 1)
            s.steps += 1
            s.decode_s += dt
            sess.toks[i, 0] = nxt[i]
            sess.tok_idx[i] += 1
            if len(s.req.done) + len(s.tokens) >= s.req.max_new_tokens:
                finished.append((s.tag, self._finish(s)))
                self._release(s, i)
                sess.slots[i] = None
                if tr.enabled:
                    self._trace_finish(s, i, t1)
        return finished

    def _grow_slot(self, sess: _Session, i: int, s: _Slot) -> None:
        """Allocate slot ``i``'s next block and install it in the table
        (lazy growth, shared by prefill chunks and decode writes)."""
        blk = self._alloc_block(i, from_reservation=s.reserve_left > 0)
        if s.reserve_left:
            s.reserve_left -= 1
        if self.tracer.enabled:
            self.tracer.instant("pool", "kv_alloc", rid=s.req.rid, n=1,
                                block=blk)
        kvcache.bt_set_entry(sess.cache, i, len(s.blocks), blk)
        s.blocks.append(blk)

    def _alloc_block(self, i: int, *, from_reservation: bool) -> int:
        """One pool allocation with overcommit pressure translation."""
        try:
            return self.allocator.alloc(self.owner,
                                        from_reservation=from_reservation)
        except MemoryError as e:
            if self._admission == "overcommit":
                if self.tracer.enabled:
                    self.tracer.instant("pool", "pool_pressure",
                                        owner=self.owner, slot=i)
                raise PoolPressure(self.owner, i) from e
            raise

    def _cow_block(self, sess: _Session, i: int, s: _Slot, c: int) -> None:
        """Copy-on-write barrier for chunk ``c`` of slot ``i``: if another
        request also holds ``blocks[c]``, allocate a private block, copy
        the shared bytes, and swap the table entry; a sole holder rewrites
        in place (the recompute produces identical bytes).  Resumable: a
        PoolPressure from the allocation mutates nothing."""
        old = s.blocks[c]
        if self.allocator.refcount(old) > 1:
            blk = self._alloc_block(i, from_reservation=s.reserve_left > 0)
            if s.reserve_left:
                s.reserve_left -= 1
            kvcache.pool_copy_block(sess.cache, blk, old)
            kvcache.bt_set_entry(sess.cache, i, c, blk)
            self.allocator.free([old], self.owner)
            s.blocks[c] = blk
            if self.tracer.enabled:
                self.tracer.instant("pool", "kv_cow", rid=s.req.rid,
                                    alloc=1, freed=1, block=blk)
        s.shared_until = c

    def _chunk_tokens(self, r: Request, chunk: int) -> torch.Tensor:
        """(1, block_size) token feed for combined positions ``[chunk*bs,
        (chunk+1)*bs)``: prompt ids where a position maps to a token, 0 at
        a model-side prefix position (vlm patches, embedded from
        ``extra_inputs`` by the model) and past the prompt (right pad,
        masked causally and overwritten as decode proceeds)."""
        bs = self.block_size
        npre = self._n_prefix()
        seq = self._prefill_seq(r)
        toks = np.zeros((1, bs), np.int32)
        lo = max(chunk * bs, npre)
        hi = min((chunk + 1) * bs, npre + len(seq))
        if hi > lo:
            toks[0, lo - chunk * bs:hi - chunk * bs] = seq[lo - npre:
                                                           hi - npre]
        return torch.from_numpy(toks).to(self.device)

    def _advance_prefill(self, sess: _Session, i: int,
                         s: _Slot) -> Result | None:
        """Run slot ``i``'s remaining prefill chunks (the prompt), then
        replay a re-admission's ``done`` through decode, allocating each
        block just before it is written (resumable after PoolPressure).
        On completion samples the request's next token; returns the
        finished Result when the token budget is satisfied by the prefill
        itself, else None."""
        r = s.req
        plen = self._n_prefix() + len(self._prefill_seq(r))
        n_chunks = blocks_needed(plen, self.block_size)
        extra = self._gather_extra([s.extra_row])   # same rows every chunk
        logits = None
        while s.chunks_done < n_chunks:
            c = s.chunks_done
            if c < s.shared_until:
                self._cow_block(sess, i, s, c)  # may raise PoolPressure
            if len(s.blocks) <= c:
                self._grow_slot(sess, i, s)     # may raise PoolPressure
            batch = {"tokens": self._chunk_tokens(r, c), **extra}
            at = self.attr
            tc0 = self.clock.now() if at.enabled else 0.0
            span = at.device_span(self.device) if at.enabled else None
            with self.tracer.span(self._slot_track(i), "chunk",
                                  rid=r.rid, chunk=c):
                logits, sess.cache = self.model.prefill_paged(
                    self.params, sess.cache, batch, i, c, plen)
            s.chunks_done += 1
            if at.enabled:
                # no sync: on the card the chunk's busy time is its event
                # span, read after the next read-back (``_flush_attr``)
                cost = self._phase_cost(("prefill_chunk",
                                         self.model.cfg.name,
                                         self.block_size))
                tc1 = self.clock.now()
                if span is None:
                    at.record_prefill(sess.metrics, self.tracer,
                                      self._slot_track(i), t0=tc0, t1=tc1,
                                      cost=cost)
                else:
                    span.stop()
                    sess.attr_pending.append(
                        (self._slot_track(i), tc0, tc1, cost, span))
        while s.replayed < len(r.done):
            pos = plen + s.replayed
            while len(s.blocks) * self.block_size <= pos:
                self._grow_slot(sess, i, s)     # may raise PoolPressure
            logits = self._replay_paged(sess, i, r.done[s.replayed], pos)
            s.replayed += 1
            # counted as it runs: a request preempted mid-replay replays
            # again on its next admission
            sess.metrics.counter("resume_replay_tokens").inc()
        if self.prefix_cache:
            # publish every full prompt block; decode writes always land
            # past the prompt, so registered bytes are prefill output
            for c, key in enumerate(kvcache.prefix_chain_keys(
                    self._prefill_seq(r), self.block_size)):
                self.allocator.register(key, s.blocks[c], self.owner)
        self._await_device()
        tok = int(_sample_rows(logits, np.asarray([r.temperature]),
                               sess.key, np.asarray([r.rid]),
                               np.asarray([len(r.done)]))[0])
        t1 = self.clock.now()
        self._flush_attr(sess)
        ttft_ms = (t1 - s.admit_t) * 1e3
        if self.tracer.enabled:
            self.tracer.complete(self._slot_track(i), "prefill",
                                 s.span_t0, t1, rid=r.rid,
                                 chunks=n_chunks, tokens=s.prefill_pos)
        if not r.done:
            sess.metrics.histogram("ttft_ms").observe(ttft_ms)
            if r.slo_ttft_ms is not None:
                self._observe_slo_ttft(r, i, s.enqueue_t, s.admit_t, t1)
        s.ttft_ms = (r.first_ttft_ms if r.first_ttft_ms is not None
                     else ttft_ms)
        s.first_tok_t = t1
        s.tokens.append(tok)
        self._emit_token(sess, r, tok, len(r.done))
        s.chunks_done = None            # prefill complete: decode from here
        if len(r.done) + 1 >= r.max_new_tokens:
            return self._finish(s)
        sess.toks[i, 0] = tok
        sess.tok_idx[i] = len(r.done) + 1
        return None

    def _replay_paged(self, sess: _Session, i: int, tok: int, pos: int):
        """Decode ``tok`` at position ``pos`` for slot ``i`` alone, as the
        uninterrupted run did: a full-width step (the engine's
        ``max_batch`` rows, slot ``i`` at its own row, every other row on
        the null block at position 0) over the shared pools, so every GEMM
        and attention launch has the shapes that run's decode had and the
        slot's row gets the same bits.  Writes the position's K/V into the
        slot's block; returns the (1, V) logits."""
        pc = sess.cache
        bt = torch.full_like(pc["bt"], kvcache.NULL_BLOCK)
        bt[i] = pc["bt"][i]
        positions = torch.zeros_like(pc["pos"])
        positions[i] = pos
        feed = torch.zeros((self.max_batch, 1), dtype=torch.int32,
                           device=self.device)
        feed[i, 0] = tok
        view = dict(pc, bt=bt, pos=positions)
        with self.tracer.span(self._slot_track(i), "replay", pos=pos):
            logits, _ = self.model.decode_paged(self.params, view, feed)
        pc["pos"][i] = pos + 1
        return logits[i:i + 1]

    def session_preempt(self, slot: int) -> tuple[int, Request]:
        """Evict the request in ``slot``: free its blocks and return
        ``(tag, requeued request)`` carrying the tokens generated so far in
        ``done``, so a re-admission reproduces the uninterrupted stream.
        A slot still mid-prefill is a valid victim."""
        sess = self._require_session()
        s = sess.slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} is not live")
        requeued = dataclasses.replace(
            s.req, done=tuple(s.req.done) + tuple(s.tokens),
            first_ttft_ms=(s.ttft_ms if s.tokens else s.req.first_ttft_ms),
            first_admit_t=s.admit_t, requeues=s.req.requeues + 1)
        tr = self.tracer
        if tr.enabled:
            st = self._slot_track(slot)
            t1 = self.clock.now()
            if s.steps:
                tr.complete(st, "decode", s.first_tok_t, t1,
                            rid=s.req.rid, tokens=s.steps)
            tr.complete(st, f"req {s.req.rid}", s.span_t0, t1,
                        rid=s.req.rid, preempted=True)
            tr.instant(st, "preempt", rid=s.req.rid,
                       tokens_done=len(requeued.done),
                       mid_prefill=s.chunks_done is not None)
            tr.flow_start(st, "preempt_flow",
                          f"preempt-{s.req.rid}-{requeued.requeues}")
        self._release(s, slot)
        sess.slots[slot] = None
        sess.metrics.counter("preempted").inc()
        return s.tag, requeued

    def session_abort(self) -> None:
        """Tear down an open session after a failure, returning any blocks
        and reservations to the pool."""
        sess = self._sess
        if sess is None:
            return
        if self.tracer.enabled:
            for i, s in enumerate(sess.slots):
                if s is not None:
                    self.tracer.instant(self._slot_track(i), "abort",
                                        rid=s.req.rid)
        for s in sess.slots if self.kv_layout == "paged" else ():
            if s is not None:
                if s.blocks:
                    self.allocator.free(s.blocks, self.owner)
                self.allocator.unreserve(s.reserve_left)
        if self.prefix_cache:
            # the aborted session's pool is not trustworthy: drop it and
            # de-index everything this engine registered
            self._pcache = None
            self.allocator.flush_index(self.owner)
        self._sess = None

    def end_session(self) -> EngineStats:
        """Close the session and return its aggregate stats."""
        sess = self._require_session()
        if self.session_active:
            raise RuntimeError("end_session with live slots (drain or "
                               "preempt them first)")
        if sess.finished_pending:
            raise RuntimeError(
                "end_session with undelivered finished Results (a "
                "PoolPressure interrupted their step; call session_step "
                "once more to collect them)")
        self._flush_attr(sess)
        wall = self.clock.now() - sess.t_start
        stats = EngineStats.from_registry(
            sess.metrics, mode=self.mode, wall_s=wall,
            kv_layout=self.kv_layout,
            prefill_compiles=len(self._prefill_shapes),
            block_util_peak=(self.allocator.stats().peak_utilization
                             if self.kv_layout == "paged" else 0.0),
            sched_policy=self.policy.name)
        self.last_metrics = sess.metrics
        if self.prefix_cache:
            self._pcache = sess.cache
        self._sess = None
        return stats

    def _finish(self, s: _Slot) -> Result:
        per_tok = s.decode_s * 1e3 / max(s.steps, 1)
        tokens = list(s.req.done) + s.tokens
        m = self._sess.metrics
        m.counter("generated_tokens").inc(len(tokens))
        if s.steps:
            m.histogram("tpot_ms").observe(per_tok)
            if s.req.slo_tpot_ms is not None:
                self._observe_slo_tpot(s, per_tok)
        return Result(s.req.rid, tokens, s.ttft_ms, per_tok)

    def _trace_finish(self, s: _Slot, i: int, t1: float) -> None:
        tr = self.tracer
        st = self._slot_track(i)
        if s.steps:
            tr.complete(st, "decode", s.first_tok_t, t1, rid=s.req.rid,
                        tokens=s.steps)
        tr.complete(st, f"req {s.req.rid}", s.span_t0, t1, rid=s.req.rid)
        tr.instant(st, "finish", rid=s.req.rid,
                   tokens=len(s.req.done) + len(s.tokens))

    def _release(self, s: _Slot, i: int) -> None:
        """Free slot ``i``'s cache-side state.  dense, scan family: zero the
        slot's state and position (``model.cache_slot_reset``), so nothing
        of the finished or preempted request survives in the pool.  dense,
        KV family: nothing - the strip is masked by the slot's pos and
        fully rewritten at the next admission.  paged: drop the slot's block
        references (an unshared block returns to the pool, a registered
        last reference parks in the cached LRU) and park its table row on
        the null block so idle decode writes cannot touch recycled
        blocks."""
        if self.kv_layout != "paged":
            reset = self.model.cache_slot_reset
            if reset is not None and self._sess.cache is not None:
                self._sess.cache = reset(self._sess.cache, i)
            return
        if self.tracer.enabled and s.blocks:
            self.tracer.instant("pool", "kv_free", rid=s.req.rid,
                                n=len(s.blocks))
        self.allocator.free(s.blocks, self.owner)
        self.allocator.unreserve(s.reserve_left)
        s.blocks, s.reserve_left = [], 0
        kvcache.slot_release(self._sess.cache, i)

    # ------------------------------------------------------------------
    # Continuous batching (slot pool + admission scheduler).
    # ------------------------------------------------------------------

    def stream(self, requests: list[Request], key=None):
        """Streaming ``generate``: a generator of :class:`TokenEvent` rows
        as tokens are sampled; the run executes on a background thread and
        any engine exception re-raises here."""
        return _stream_events(
            lambda cb: self.generate(requests, key=key, on_token=cb))

    def _generate_continuous(self, items, key, on_token=None) \
            -> list[Result]:
        """items: [(submission order, Request)]; results align with items."""
        self.begin_session(key, on_token)
        queue = collections.deque(
            (seq, order, r) for seq, (order, r) in enumerate(items))
        results: list[Result | None] = [None] * len(items)
        try:
            while queue or self.session_active:
                # admission: refill every free slot before the next step,
                # stopping at the first inadmissible pick (no skip-ahead)
                while queue and self.session_free_slot() is not None:
                    if self.policy.reorders:
                        now = self.clock.now()
                        item = min(queue,
                                   key=lambda it: self.policy.order_key(
                                       it[0], it[2], self._sess.t_start,
                                       now))
                    else:
                        item = queue[0]
                    seq, order, r = item
                    if not self.session_can_admit(r):
                        break
                    queue.remove(item)
                    res = self.session_admit(r, tag=seq, extra_row=order,
                                             enqueue_t=self._sess.t_start)
                    if res is not None:
                        results[seq] = res
                if queue and not self.session_active:
                    raise MemoryError(
                        f"engine owner={self.owner!r} is idle but the "
                        f"shared pool cannot admit rid="
                        f"{queue[0][2].rid} (co-tenants hold "
                        f"{self.allocator.n_live} blocks, "
                        f"{self.allocator.n_reserved} reserved)")
                for tag, res in self.session_step():
                    results[tag] = res
        except BaseException:
            # keep the allocator consistent if anything aborts the batch
            self.session_abort()
            raise
        self.last_stats = self.end_session()
        return results

    # ------------------------------------------------------------------
    # Lock-step group batching (the baseline scheduler, dense layout).
    # ------------------------------------------------------------------

    def _pad_prompts(self, prompts: list[list[int]]) -> np.ndarray:
        """Left-pad to a common length (the uniform-position cache
        layout).  The pads are token 0 and are attended as real tokens, as
        in the reference."""
        maxlen = max(len(p) for p in prompts)
        out = np.zeros((len(prompts), maxlen), np.int32)
        for i, p in enumerate(prompts):
            out[i, maxlen - len(p):] = p
        return out

    def _generate_lockstep(self, items, key) -> list[Result]:
        """items: [(submission order, Request)]; results align with items."""
        results: list[Result | None] = [None] * len(items)
        queue = [(seq, order, r) for seq, (order, r) in enumerate(items)]
        m = MetricsRegistry()
        t_start = self.clock.now()
        while queue:
            group = queue[: self.max_batch]
            queue = queue[self.max_batch:]
            self._generate_group(group, key, results, m)
        wall = self.clock.now() - t_start
        m.counter("generated_tokens").inc(
            sum(len(r.tokens) for r in results))
        self.last_metrics = m
        self.last_stats = EngineStats.from_registry(
            m, mode="lockstep", wall_s=wall,
            prefill_compiles=len(self._prefill_shapes))
        return results

    def _generate_group(self, group, key, results, m: MetricsRegistry):
        """One group: a batched prefill of the left-padded prompts, then
        decode steps until the longest budget is spent (a finished row's
        lane idles until then).  Every row of the group sits at one
        position, so the group's longest prompt and budget set the write
        budget."""
        reqs = [r for _, _, r in group]
        prompts = self._pad_prompts([list(r.prompt) + list(r.done)
                                     for r in reqs])
        remaining = [r.max_new_tokens - len(r.done) for r in reqs]
        max_new = max(remaining)
        self._check_budget(self._n_prefix() + prompts.shape[1], max_new,
                           [r.rid for r in reqs])
        self._prefill_shapes.add(prompts.shape[1])
        batch = {"tokens": torch.from_numpy(prompts).to(self.device),
                 **self._gather_extra([order for _, order, _ in group])}
        t0 = self.clock.now()
        logits, cache = self.model.prefill(self.params, batch,
                                           cache_len=self.cache_len)
        temps = np.asarray([r.temperature for r in reqs], np.float32)
        rids = np.asarray([r.rid for r in reqs], np.int32)
        base_idx = np.asarray([len(r.done) for r in reqs], np.int32)
        toks = _sample_rows(logits, temps, key, rids, base_idx)
        t_pf = self.clock.now()
        prefill_ms = (t_pf - t0) * 1e3     # to the first sampled tokens
        if self.tracer.enabled:
            self.tracer.complete(self.track, "prefill", t0, t_pf,
                                 group=len(reqs))
        outs = [[int(t)] for t in toks]
        t1 = self.clock.now()
        n_steps = 0
        for _ in range(max_new - 1):
            feed = torch.from_numpy(toks.astype(np.int32)[:, None])
            logits, cache = self.model.decode(self.params, cache,
                                              feed.to(self.device))
            n_steps += 1
            toks = _sample_rows(logits, temps, key, rids, base_idx + n_steps)
            for i in range(len(reqs)):
                if len(outs[i]) < remaining[i]:
                    outs[i].append(int(toks[i]))
        t2 = self.clock.now()
        decode_ms = (t2 - t1) * 1e3 / max(n_steps, 1)
        if self.tracer.enabled and n_steps:
            self.tracer.complete(self.track, "decode_group", t1, t2,
                                 steps=n_steps, group=len(reqs))
        # request i is busy for its first (remaining - 1) decode steps
        busy_total = sum(min(max(rem - 1, 0), n_steps) for rem in remaining)
        m.counter("decode_steps").inc(n_steps)
        m.counter("busy_slot_steps").inc(busy_total)
        m.counter("offered_slot_steps").inc(self.max_batch * n_steps)
        for _ in reqs:
            m.histogram("ttft_ms").observe(prefill_ms)
        for i, (seq, _, r) in enumerate(group):
            results[seq] = Result(r.rid, list(r.done) + outs[i], prefill_ms,
                                  decode_ms)
            if remaining[i] > 1:
                m.histogram("tpot_ms").observe(decode_ms)
