"""Multi-replica serving cluster: router + shared KV pool + preemption.

The port's counterpart of ``repro/serving/cluster.py``.  Ara2's headline
multi-core result (§7) is that eight 2-lane cores with 16 FPUs beat one
16-lane core with the same 16 FPUs by >3x on matmul: many small issue
streams overcome the single scalar-core issue-rate bound.  The serving
analog:

* ``ClusterEngine`` owns N ``ServeEngine`` replicas, each with
  ``max_batch = total_slots / N`` decode slots - the "cores".  A wide
  single engine pays its full decode width on every step even when most
  slots idle; narrow replicas strand at most their own width, and a
  drained replica skips its step entirely.

* a **router** admits from one global FIFO queue into whichever replica
  has a free slot (``ROUTER_POLICIES``): ``round_robin`` (cyclic),
  ``least_loaded`` (fewest busy slots) or ``shortest_queue`` (smallest
  outstanding decode-token backlog).  Greedy outputs are
  policy-independent, and sampled streams are keyed by request id, not by
  slot or replica (``engine._sample_rows``).

* the dense family serves through the **paged** KV layout; the hybrid
  family has no block pool to share (its per-slot recurrent state is O(1)
  per request), so its replicas run the **dense slot layout**
  (``kv_layout="auto"`` resolves per family).  Only the pool-pressure
  machinery below is paged-specific.

* paged replicas draw KV blocks from one **shared**
  :class:`~repro_torch.serving.kvcache.BlockAllocator` (per-owner
  accounting: owner = replica index) under ``admission="overcommit"``: a
  request is admitted as soon as its first prefill chunk fits.  When a
  replica's lazy block growth finds the pool empty
  (:class:`~repro_torch.serving.kvcache.PoolPressure`), the cluster
  **preempts** the policy's victim anywhere in the cluster: its blocks are
  freed and it is re-queued carrying its generated prefix
  (``Request.done``) for re-prefill.  Request-keyed sampling makes the
  resumed stream identical to the uninterrupted one, so preemption is
  invisible in the output.  ``admission="reserve"`` gives a cluster that
  never preempts.

* with ``prefix_cache=True`` (paged only) every replica registers and
  resolves prompt-prefix blocks in the shared allocator's index, tagged
  with the writer replica, and ``lookup`` is scoped to it: block
  *accounting* is pool-global but the device pools are per replica (below),
  so only the replica whose pool holds the bytes may admit by reference.

* requeued victims re-enter behind a **preemption hysteresis**
  (``preempt_hysteresis`` scheduler rounds, waived when the cluster is
  idle), so a victim does not bounce straight back into the pressure that
  evicted it.

* two **drivers** (``DRIVERS``).  ``sequential`` (default) steps the
  replicas in one deterministic loop.  ``threaded`` runs each replica in a
  worker thread; a coordinator (the calling thread) owns the global queue
  and every routing and victim decision, workers own every session
  mutation on their replica, and ``PoolPressure`` travels to the
  coordinator as an event.  On the card each worker runs its replica under
  its own ``torch.cuda.Stream``: the hand kernels launch on the current
  stream, and a step's token read-back syncs only that stream, so the N
  replicas' host dispatch and kernels overlap - the serving twin of the
  paper's N concurrent issue streams.  The coordinator makes no device
  tensor, a worker's streams wait for the launching stream before its
  first step and finish before it exits, and a block that one replica
  frees and another allocates lives in two different device pools, so no
  tensor crosses streams.  Tokens are byte-identical under both drivers.

Device memory: each replica's device pool is sized to the whole shared
pool (``n_blocks``), so the shared allocator's block ids index it
directly, as in the reference; ``last_pool_bytes`` reports the sum.

Utilization attribution (``attribution=`` / ``set_attributor``): one
attributor is shared by every replica; its cost memo is shape-keyed (and
locked, for the threaded driver), each replica records into its own
registry, and ``_aggregate``'s merge derives the cluster's figures from the
union.

Per-request side inputs (``extra_inputs=``, the vlm's patches) go to
every replica whole; a request's row is its submission order, whichever
replica admits it and however often it is preempted.

Not ported yet: the encdec family's ``extra_inputs`` (encoder frames).
"""
from __future__ import annotations

import collections
import contextlib
import queue as queue_mod
import threading

import torch

from ..models.model import Model
from . import sampling
from .engine import (EngineStats, Request, Result, ServeEngine,
                     _stream_events)
from .kvcache import BlockAllocator, PoolPressure, blocks_needed
from .slo import make_policy, slo_budget_s
from .telemetry import MONOTONIC, NULL_TRACER, MetricsRegistry

ROUTER_POLICIES = ("round_robin", "least_loaded", "shortest_queue")
DRIVERS = ("sequential", "threaded")

#: Coordinator-side guard against a wedged worker: no worker event for
#: this long means a protocol bug (a healthy step, even a first kernel
#: build, lands well inside it) - fail loudly instead of hanging.
_EVENT_TIMEOUT_S = 300.0


class ClusterEngine:
    """N narrow ServeEngine replicas behind a router, sharing one KV block
    pool.

    replicas / total_slots: replica count and the summed slot budget
    (``total_slots % replicas == 0``); each replica runs the continuous
    scheduler.  kv_layout: "auto" (paged when the family has paged hooks,
    else the dense slot layout - the hybrid family), "paged", or "dense".
    block_size / n_blocks size the shared pool (paged only) - n_blocks
    defaults to the dense footprint of the whole cluster (total_slots *
    cache_len positions) plus the null block.  router: one of
    ``ROUTER_POLICIES``.  admission: "overcommit" (default; preemption
    resolves pool pressure) or "reserve"; ignored by the dense layout.
    ``pool`` is the shared BlockAllocator (None for dense clusters).

    driver: one of ``DRIVERS``; ``generate`` / ``stream`` take a per-call
    override.  Under the threaded driver ``preempt_hysteresis`` counts
    cluster-wide step completions rather than scheduler rounds.

    preempt_hysteresis: a preempted request is not re-admissible before
    ``k`` scheduler rounds have passed since its eviction; head-of-line
    blocking is kept, and the wait is waived while the cluster is idle.

    policy: a scheduling policy of ``serving.slo.POLICIES`` (or a
    ``SchedPolicy``), threaded to every replica; ``slo_adaptive`` adds
    slack routing, deadline-protected victim picks and the starvation
    signal (a ready queued request inside ``slo_guard_ms`` of its TTFT
    deadline with no replica free preempts one unprotected victim).  With
    no budgets set every policy emits fifo's tokens.

    prefix_cache: paged clusters only (writer-scoped lookups in the shared
    allocator).

    ``generate`` mirrors ``ServeEngine.generate``; ``last_stats`` is the
    cluster aggregate (mode="cluster", ``router_policy`` set, percentiles
    over the *merged* replica samples) and ``replica_stats`` keeps each
    replica's EngineStats.  tracer / clock: telemetry, cascaded to every
    replica (track ``replica{i}``) and the shared pool; routing, victim
    picks, requeues and hysteresis waits land on the ``cluster`` track.
    attribution: one ``serving.attribution.Attributor`` for every replica.
    extra_inputs: as ``ServeEngine``'s, given to every replica.
    The device is the parameters' device.
    """

    def __init__(self, model: Model, params, *, replicas: int = 2,
                 total_slots: int = 8, cache_len: int = 1024,
                 router: str = "round_robin", kv_layout: str = "auto",
                 block_size: int = 16,
                 n_blocks: int | None = None,
                 bucket: str | int | None = None,
                 admission: str = "overcommit",
                 preempt_hysteresis: int = 4,
                 prefix_cache: bool = False,
                 driver: str = "sequential",
                 policy="fifo", slo_guard_ms: float = 50.0,
                 tracer=None, clock=None, attribution=None,
                 extra_inputs: dict | None = None):
        if router not in ROUTER_POLICIES:
            raise ValueError(f"router={router!r}: pick one of "
                             f"{ROUTER_POLICIES}")
        if driver not in DRIVERS:
            raise ValueError(f"driver={driver!r}: pick one of {DRIVERS}")
        if replicas < 1 or total_slots % replicas:
            raise ValueError(
                f"total_slots={total_slots} must be a positive multiple of "
                f"replicas={replicas}")
        if kv_layout not in ("auto", "paged", "dense"):
            raise ValueError(f"kv_layout={kv_layout!r}")
        if kv_layout == "auto":
            kv_layout = "paged" if model.decode_paged is not None else "dense"
        if kv_layout == "paged" and model.decode_paged is None:
            raise ValueError(
                f"kv_layout='paged': family {model.cfg.family!r} has no "
                "paged cache hooks (scan families cluster on the dense "
                "slot layout)")
        if preempt_hysteresis < 0:
            raise ValueError(
                f"preempt_hysteresis={preempt_hysteresis} must be >= 0")
        if slo_guard_ms < 0:
            raise ValueError(f"slo_guard_ms={slo_guard_ms} must be >= 0")
        self.router = router
        self.driver = driver
        self.total_slots = total_slots
        self.kv_layout = kv_layout
        self.preempt_hysteresis = preempt_hysteresis
        self.policy = make_policy(policy)
        self.slo_guard_ms = slo_guard_ms
        if kv_layout == "paged":
            if n_blocks is None:
                n_blocks = (total_slots * blocks_needed(cache_len,
                                                        block_size) + 1)
            self.pool = BlockAllocator(n_blocks, block_size)
            layout_kw = dict(kv_layout="paged", allocator=self.pool,
                             admission=admission,
                             prefix_cache=prefix_cache)
        else:
            # scan families: per-slot recurrent state, no shared pool, no
            # pool pressure - admission is bounded by free slots alone
            if prefix_cache:
                raise ValueError(
                    "prefix_cache=True requires the paged layout (dense "
                    "scan-family replicas have no blocks to share)")
            self.pool = None
            layout_kw = dict(kv_layout="dense")
        self.engines = [
            ServeEngine(model, params, max_batch=total_slots // replicas,
                        cache_len=cache_len, mode="continuous", bucket=bucket,
                        owner=i, track=f"replica{i}", policy=self.policy,
                        extra_inputs=extra_inputs, **layout_kw)
            for i in range(replicas)]
        self.device = self.engines[0].device
        self._streams = None        # a CUDA stream a replica, made on demand
        self.last_stats: EngineStats | None = None
        self.replica_stats: list[EngineStats] = []
        self.last_metrics = MetricsRegistry()
        self.last_pool_bytes = 0   # device bytes of the last run's caches
        self._rr = 0
        self.tracer = NULL_TRACER
        self.clock = MONOTONIC
        if tracer is not None:
            self.set_tracer(tracer)
        if clock is not None:
            self.clock = clock
            for e in self.engines:
                e.clock = clock
        if attribution is not None:
            self.set_attributor(attribution)

    def _session_cache_bytes(self) -> int:
        """Device bytes of the open sessions' caches: each paged replica's
        pool spans the whole shared pool's ``n_blocks``; a dense replica
        holds its slots' strips or state."""
        return sum(t.numel() * t.element_size()
                   for e in self.engines if e._sess is not None
                   for t in (e._sess.cache or {}).values()
                   if isinstance(t, torch.Tensor))

    def set_attributor(self, attributor) -> None:
        """Attach (or detach, with None) one utilization attributor to every
        replica (``ServeEngine.set_attributor``).  Sharing it is
        deliberate: N identical replicas fill one memo entry per (phase,
        shape), and the rollup needs no plumbing - each replica records raw
        ``attr_*`` samples into its registry and ``_aggregate``'s merge
        derives the cluster's utilization from the union."""
        for e in self.engines:
            e.set_attributor(attributor)

    def set_tracer(self, tracer) -> None:
        """Attach (or detach, with None) a tracer, cascading it to every
        replica and the shared pool; the cluster adopts an enabled
        tracer's clock (like ``ServeEngine.set_tracer``)."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if self.tracer.enabled:
            self.clock = self.tracer.clock
        for e in self.engines:
            e.set_tracer(tracer)
        if self.pool is not None:
            self.pool.set_tracer(self.tracer)

    # ------------------------------------------------------------------
    # Routing.
    # ------------------------------------------------------------------

    def _route(self, r: Request) -> ServeEngine | None:
        """Pick the replica to admit ``r`` into, or None when no replica
        has both a free slot and pool headroom.  A slack-routing policy
        (``slo_adaptive``) sends *budgeted* requests to the emptiest
        replica regardless of the configured router, while best-effort
        traffic keeps the configured policy."""
        cands = [e for e in self.engines
                 if e.session_free_slot() is not None
                 and e.session_can_admit(r)]
        if not cands:
            return None
        if self.policy.slack_routes and slo_budget_s(r) is not None:
            return min(cands, key=lambda e: (e.session_active,
                                             self.engines.index(e)))
        if self.router == "round_robin":
            n = len(self.engines)
            for off in range(n):
                e = self.engines[(self._rr + off) % n]
                if e in cands:
                    self._rr = (self._rr + off + 1) % n
                    return e
            raise AssertionError(
                "round_robin scanned every replica without hitting a "
                "candidate despite cands being non-empty - routing "
                "invariant broken")
        if self.router == "least_loaded":
            return min(cands, key=lambda e: (e.session_active,
                                             self.engines.index(e)))
        return min(cands, key=lambda e: (e.session_backlog(),
                                         self.engines.index(e)))

    # ------------------------------------------------------------------
    # Preemption.
    # ------------------------------------------------------------------

    def _pick_victim(self, excl_engine, excl_slot, now: float | None = None,
                     require_unprotected: bool = False):
        """Policy-ranked victim pick across the cluster (the minimum
        ``victim_key`` anywhere), excluding the slot whose growth raised
        the pressure (preempting the requester would just redo its own
        work).  ``require_unprotected=True`` (the starvation path) refuses
        protected victims outright."""
        now = self.clock.now() if now is None else now
        cands = []
        for e in self.engines:
            if e.session_active == 0:
                continue
            for key, i in e.session_victims(now):
                if e is excl_engine and i == excl_slot:
                    continue
                if require_unprotected and key[0]:
                    continue
                cands.append((key, e.owner, e, i))
        if not cands:
            return None
        _, _, e, i = min(cands, key=lambda c: (c[0], c[1]))
        return e, i

    def _requeue(self, queue, item) -> None:
        """Insert a preempted request back into the global queue keeping it
        sorted by submission order.  Queue items are (seq, order, request,
        ready_round, enqueue_t); seq is unique, so the sort never compares
        requests."""
        queue.append(item)
        ordered = sorted(queue, key=lambda it: it[0])
        queue.clear()
        queue.extend(ordered)

    def _hysteresis_wait(self, cm, tr, r, rounds_left: int) -> None:
        cm.counter("hysteresis_wait_rounds").inc()
        if tr.enabled:
            tr.instant("cluster", "hysteresis_wait", rid=r.rid,
                       rounds_left=rounds_left)

    def _next_item(self, queue, rounds: int, busy: bool, cm, tr):
        """Pick the next admission candidate from the global queue,
        honoring the preemption hysteresis.  fifo keeps head-of-line
        semantics (the head blocks, nothing skips past a cooling-down
        victim, the cool-down is waived when the cluster is idle);
        reordering policies take the minimum ``order_key`` over *ready*
        items.  Returns the queue item, or None when nothing is
        admissible now."""
        if not queue:
            return None
        if not self.policy.reorders:
            item = queue[0]
            if item[3] > rounds and busy:
                self._hysteresis_wait(cm, tr, item[2], item[3] - rounds)
                return None
            return item
        eligible = [it for it in queue if it[3] <= rounds]
        if not eligible:
            if busy:
                self._hysteresis_wait(cm, tr, queue[0][2],
                                      queue[0][3] - rounds)
                return None
            eligible = list(queue)   # idle cluster waives the cool-down
        now = self.clock.now()
        return min(eligible, key=lambda it: self.policy.order_key(
            it[0], it[2], it[4], now))

    def _starving_item(self, queue, rounds: int):
        """The dense/scan pressure signal (``slo_adaptive`` only): the
        most urgent *ready* queued request whose remaining TTFT slack has
        fallen inside the guard band, or None."""
        if not (self.policy.preempts_on_starvation and queue):
            return None
        eligible = [it for it in queue if it[3] <= rounds]
        if not eligible:
            return None
        now = self.clock.now()
        item = min(eligible, key=lambda it: self.policy.order_key(
            it[0], it[2], it[4], now))
        if not self.policy.starving(item[2], item[4], now,
                                    self.slo_guard_ms / 1e3):
            return None
        return item

    # ------------------------------------------------------------------
    # Public API.
    # ------------------------------------------------------------------

    def generate(self, requests: list[Request], key=None, on_token=None,
                 driver: str | None = None) -> list[Result]:
        """Run ``requests`` to completion across the cluster.

        ``on_token`` streams every sampled token as a
        :class:`~repro_torch.serving.engine.TokenEvent`; under the threaded
        driver it fires from replica worker threads, so it must be
        thread-safe (``stream`` wraps this in a queue).  ``key``: the base
        key of sampled rows, two uint32 words (None: seed 0).  ``driver``
        overrides the constructor's choice for this call; tokens are
        byte-identical either way."""
        driver = self.driver if driver is None else driver
        if driver not in DRIVERS:
            raise ValueError(f"driver={driver!r}: pick one of {DRIVERS}")
        key = sampling.as_key(key)
        requests = list(requests)
        todo = [(i, r) for i, r in enumerate(requests)
                if r.max_new_tokens - len(r.done) > 0]
        results = [Result(r.rid, list(r.done)) for r in requests]
        if not todo:
            self.replica_stats = []
            self.last_stats = self._aggregate(0.0, [])
            return results
        for _, r in todo:
            self.engines[0].check_request(r)
        if self.pool is not None:
            self.pool.reset_peak()
        # every replica gets the same base key: sampling streams are keyed
        # by request id, so placement cannot change sampled outputs
        for e in self.engines:
            e.begin_session(key, on_token)
        t_start = self.clock.now()
        # cluster-level metrics (merged with the replicas' at aggregate):
        # scheduler-loop counters the engines cannot see
        cm = MetricsRegistry()
        out: list[Result | None] = [None] * len(todo)
        try:
            if driver == "threaded":
                self._drive_threaded(todo, out, cm, t_start)
            else:
                self._drive_sequential(todo, out, cm, t_start)
        except BaseException:
            for e in self.engines:
                e.session_abort()
            raise
        finally:
            if self.device.type == "cuda":
                # nothing of this call stays queued on any stream
                torch.cuda.synchronize(self.device)
        wall = self.clock.now() - t_start
        self.last_pool_bytes = self._session_cache_bytes()
        self.replica_stats = [e.end_session() for e in self.engines]
        self.last_stats = self._aggregate(
            wall, [e.last_metrics for e in self.engines], cm)
        for (i, _), res in zip(todo, out):
            results[i] = res
        return results

    def stream(self, requests: list[Request], key=None,
               driver: str | None = None):
        """Streaming ``generate``: a generator yielding TokenEvent rows as
        replicas sample them (per-rid events in index order).  The
        underlying ``generate`` runs on a background thread; exhaust the
        generator (or let an exception propagate) before reusing the
        engine."""
        return _stream_events(
            lambda cb: self.generate(requests, key=key, on_token=cb,
                                     driver=driver))

    # ------------------------------------------------------------------
    # Sequential driver: replicas stepped round-robin in one loop.
    # ------------------------------------------------------------------

    def _drive_sequential(self, todo, out, cm, t_start) -> None:
        tr = self.tracer
        queue = collections.deque(
            (seq, order, r, 0, t_start) for seq, (order, r)
            in enumerate(todo))
        admit_seq = 0
        rounds = 0
        while queue or any(e.session_active for e in self.engines):
            # route: the policy's next pick into a replica with slot +
            # pool headroom (fifo: the FIFO head, head-of-line blocking)
            while queue:
                busy = any(e.session_active for e in self.engines)
                item = self._next_item(queue, rounds, busy, cm, tr)
                if item is None:
                    break
                seq, order, r, ready, enq_t = item
                e = self._route(r)
                if e is None:
                    break
                queue.remove(item)
                if tr.enabled:
                    tr.instant("cluster", "route", rid=r.rid,
                               replica=e.owner, policy=self.router)
                # paged admission always defers to session_step, but a
                # dense (scan-family) admission runs the prefill here
                # and can satisfy a 1-token budget on the spot
                res = e.session_admit(r, tag=seq, extra_row=order,
                                      admit_seq=admit_seq, enqueue_t=enq_t)
                if res is not None:
                    out[seq] = res
                admit_seq += 1
            # starvation pressure (slo_adaptive): a ready queued request
            # is about to miss its TTFT deadline and no replica can take
            # it - preempt one unprotected victim so the next round's
            # admission pass can place it
            stepped = False
            starving = self._starving_item(queue, rounds)
            # slot-count probe without _route: routing round_robin
            # advances self._rr even when the pick is discarded
            if starving is not None and not any(
                    e.session_free_slot() is not None
                    and e.session_can_admit(starving[2])
                    for e in self.engines):
                victim = self._pick_victim(None, None,
                                           require_unprotected=True)
                if victim is not None:
                    ve, vi = victim
                    tag, r2 = ve.session_preempt(vi)
                    cm.counter("slo_starve_preempts").inc()
                    ready_rnd = rounds + self.preempt_hysteresis
                    if tr.enabled:
                        tr.instant("cluster", "preempt_pick", rid=r2.rid,
                                   replica=ve.owner, slot=vi,
                                   starved=starving[2].rid)
                        tr.instant("cluster", "requeue", rid=r2.rid,
                                   ready_round=ready_rnd)
                    self._requeue(queue, (tag, todo[tag][0], r2,
                                          ready_rnd, self.clock.now()))
                    stepped = True   # progress: the freed slot admits
                    #                  the starving request next round
            for e in self.engines:
                if e.session_active == 0:
                    continue      # a drained replica skips its step
                while True:
                    try:
                        finished = e.session_step()
                        break
                    except PoolPressure as p:
                        victim = self._pick_victim(e, p.slot)
                        if victim is None:
                            raise   # nothing to evict: genuine OOM
                        ve, vi = victim
                        tag, r2 = ve.session_preempt(vi)
                        ready_rnd = rounds + self.preempt_hysteresis
                        if tr.enabled:
                            tr.instant("cluster", "preempt_pick",
                                       rid=r2.rid, replica=ve.owner,
                                       slot=vi, pressured=e.owner)
                            tr.instant("cluster", "requeue", rid=r2.rid,
                                       ready_round=ready_rnd)
                        self._requeue(queue, (tag, todo[tag][0], r2,
                                              ready_rnd, self.clock.now()))
                for tag, res in finished:
                    out[tag] = res
                stepped = True
            rounds += 1
            if not stepped and queue:
                # no replica active and the head cannot be admitted:
                # impossible once check_request passed (an idle cluster
                # has every block free and waives the hysteresis), so
                # fail loudly over spinning
                raise RuntimeError(
                    "cluster stalled with a non-empty queue")

    # ------------------------------------------------------------------
    # Threaded driver: one worker thread per replica + a coordinator.
    #
    # The coordinator (the calling thread) owns the global queue, all
    # routing decisions and all victim picks; workers own every session
    # mutation on their replica.  Commands flow coordinator -> worker over
    # per-replica inboxes:
    #
    #   ("admit", item, admit_seq)  admit the queue item
    #   ("preempt", rid)            evict rid if it is live here
    #   ("resume",)                 retry the step after a pressure stop
    #   ("stop",)                   drain and exit
    #
    # and events flow worker -> coordinator over one shared queue:
    #
    #   ("admitted", i, seq, rid, res)  admit done (res: dense instant
    #                                   finish)
    #   ("admit_retry", i, item, rid)   reserve lost a pool race
    #                                   (MemoryError) - requeue it
    #   ("step_done", i, finished, backlog)  one step retired
    #   ("pressure", i, slot, rid)      PoolPressure: worker now blocks
    #                                   on its inbox until "resume"
    #   ("preempted", i, tag, req)      a "preempt" hit - blocks freed
    #   ("preempt_miss", i, rid)        rid no longer live (finished in
    #                                   flight) - coordinator re-picks
    #   ("error", i, exc)               worker died; exc re-raises
    #   ("stopped", i)                  worker exited
    #
    # The coordinator tracks slots_used per replica itself (+1 on admit
    # dispatch, -1 on finish/instant-result/retry/preempt), so it never
    # over-admits however far a worker lags.  Pool races the tracking
    # cannot see resolve through the protocol: a lost reserve returns as
    # admit_retry, a lost block-grow as pressure -> coordinator-picked
    # preempt -> resume.  Pressures are serviced one preempt at a time, so
    # each "preempted" event resolves the pressure at the head of the
    # pending deque.
    # ------------------------------------------------------------------

    def _replica_streams(self):
        """One CUDA stream a replica (made once), or None on the CPU."""
        if self.device.type != "cuda":
            return None
        if self._streams is None:
            self._streams = [torch.cuda.Stream(self.device)
                             for _ in self.engines]
        return self._streams

    def _drive_threaded(self, todo, out, cm, t_start) -> None:
        tr = self.tracer
        n = len(self.engines)
        per_replica = self.total_slots // n
        streams = self._replica_streams()
        if streams is not None:
            # the replicas read what the calling stream wrote (weights,
            # a prefix-cached pool): their streams start behind it
            caller = torch.cuda.current_stream(self.device)
            for s in streams:
                s.wait_stream(caller)
        events: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        inboxes = [queue_mod.SimpleQueue() for _ in range(n)]
        dispatch = threading.Lock()     # one worker runs the host at a time
        workers = [
            threading.Thread(target=self._replica_worker,
                             name=f"cluster-replica{i}",
                             args=(i, self.engines[i], inboxes[i], events,
                                   None if streams is None else streams[i],
                                   dispatch),
                             daemon=True)
            for i in range(n)]
        queue = collections.deque(
            (seq, order, r, 0, t_start) for seq, (order, r)
            in enumerate(todo))
        slots_used = [0] * n      # admits dispatched minus retirements
        backlog = [0] * n         # advisory decode-token backlog
        # rid -> (replica, request, admit_seq, dispatch time): the
        # victim-pick view
        assignment: dict[int, tuple[int, Request, int, float]] = {}
        pending = collections.deque()   # unresolved (replica, slot, rid)
        state = {"admit_seq": 0, "inflight": 0, "rounds": 0, "done": 0,
                 "outstanding": None}
        # outstanding: (victim_rid, replica, kind) - kind "pressure"
        # (resolves pending[0] and resumes the blocked worker) or
        # "starve" (starvation preempt: nothing to resume)

        def victim_cands(now, exclude=(), unprotected_only=False):
            """Policy-ranked victim candidates over the coordinator's
            assignment view (min = preferred victim; ties by rid)."""
            return [(self.policy.victim_key(req, aseq, t0, now), rid, vi)
                    for rid, (vi, req, aseq, t0) in assignment.items()
                    if rid not in exclude
                    and not (unprotected_only
                             and self.policy.victim_key(req, aseq, t0,
                                                        now)[0])]

        def service_pressure():
            """Issue the next preempt for the pressure at the head of
            ``pending`` (one at a time)."""
            if state["outstanding"] is not None:
                return
            while pending and self.pool.n_avail > 0:
                # stale: blocks came free since the pressure was raised (a
                # request finished in flight) - the worker retries its
                # step, and nothing is evicted
                req_i, _slot, _rid = pending.popleft()
                inboxes[req_i].put(("resume",))
            if not pending:
                return
            req_i, _slot, grow_rid = pending[0]
            # evict no request whose own growth is blocked waiting on us
            # (preempting a requester just redoes its own work) - unless
            # every live request is such a grower: then another grower
            # goes, and its own pressure is void ("preempted" below)
            growers = {p[2] for p in pending}
            now = self.clock.now()
            cands = (victim_cands(now, exclude=growers)
                     or victim_cands(now, exclude={grow_rid}))
            if not cands:
                raise RuntimeError(
                    "pool pressure with nothing preemptible: genuine "
                    "OOM (check_request should have made this "
                    "impossible)")
            _, vrid, vi = min(cands)
            if tr.enabled:
                tr.instant("cluster", "preempt_pick", rid=vrid,
                           replica=vi, pressured=req_i)
            state["outstanding"] = (vrid, vi, "pressure")
            inboxes[vi].put(("preempt", vrid))

        def service_starvation():
            """The starvation signal, threaded-driver side; deferred while
            any pool pressure is in flight."""
            if (state["outstanding"] is not None or pending
                    or not assignment):
                return
            item = self._starving_item(queue, state["rounds"])
            # slot-count probe (not _route_threaded: round_robin would
            # advance self._rr on a discarded pick)
            if item is None or any(
                    slots_used[i] < per_replica
                    and e.session_can_admit(item[2])
                    for i, e in enumerate(self.engines)):
                return
            cands = victim_cands(self.clock.now(), unprotected_only=True)
            if not cands:
                return
            _, vrid, vi = min(cands)
            cm.counter("slo_starve_preempts").inc()
            if tr.enabled:
                tr.instant("cluster", "preempt_pick", rid=vrid,
                           replica=vi, starved=item[2].rid)
            state["outstanding"] = (vrid, vi, "starve")
            inboxes[vi].put(("preempt", vrid))

        def handle(ev):
            kind = ev[0]
            if kind == "admitted":
                _, i, seq, rid, res = ev
                state["inflight"] -= 1
                if res is not None:
                    # dense instant finish: the slot was never occupied
                    out[seq] = res
                    state["done"] += 1
                    slots_used[i] -= 1
                    assignment.pop(rid, None)
            elif kind == "admit_retry":
                _, i, item, rid = ev
                state["inflight"] -= 1
                slots_used[i] -= 1
                backlog[i] -= (item[2].max_new_tokens
                               - len(item[2].done))
                assignment.pop(rid, None)
                self._requeue(queue, item)
            elif kind == "step_done":
                _, i, finished, bk = ev
                state["rounds"] += 1
                backlog[i] = bk
                for tag, res in finished:
                    out[tag] = res
                    state["done"] += 1
                    slots_used[i] -= 1
                    assignment.pop(res.rid, None)
            elif kind == "pressure":
                _, i, slot, rid = ev
                pending.append((i, slot, rid))
            elif kind == "preempted":
                _, vi, tag, r2 = ev
                slots_used[vi] -= 1
                assignment.pop(r2.rid, None)
                _vrid, _vrepl, why = state["outstanding"]
                state["outstanding"] = None
                ready = state["rounds"] + self.preempt_hysteresis
                if tr.enabled:
                    tr.instant("cluster", "requeue", rid=r2.rid,
                               ready_round=ready)
                self._requeue(queue, (tag, todo[tag][0], r2, ready,
                                      self.clock.now()))
                if why == "pressure":
                    req_i, _slot, _rid = pending.popleft()
                    inboxes[req_i].put(("resume",))
                # a preempted grower's own pressure is void: its worker
                # retries its step without the evicted slot
                for p in [p for p in pending if p[2] == r2.rid]:
                    pending.remove(p)
                    inboxes[p[0]].put(("resume",))
                # "starve": no pressured worker is blocked - the freed
                # slot simply admits the starving request next pass
            elif kind == "preempt_miss":
                # the pick finished in flight; its step_done was queued
                # before this miss, so the re-pick sees it retired
                state["outstanding"] = None
            elif kind == "error":
                raise ev[2]
            # "stopped" outside shutdown: an error event preceded it

        try:
            for w in workers:
                w.start()
            while state["done"] < len(todo):
                # admission dispatch (mirrors the sequential head loop)
                while queue:
                    busy = state["inflight"] > 0 or any(slots_used)
                    item = self._next_item(queue, state["rounds"], busy,
                                           cm, tr)
                    if item is None:
                        break
                    seq, order, r, ready, enq_t = item
                    i = self._route_threaded(r, slots_used, backlog,
                                             per_replica)
                    if i is None:
                        break
                    queue.remove(item)
                    if tr.enabled:
                        tr.instant("cluster", "route", rid=r.rid,
                                   replica=i, policy=self.router)
                    slots_used[i] += 1
                    backlog[i] += r.max_new_tokens - len(r.done)
                    state["inflight"] += 1
                    assignment[r.rid] = (i, r, state["admit_seq"],
                                         self.clock.now())
                    inboxes[i].put(("admit", (seq, order, r, ready,
                                              enq_t),
                                    state["admit_seq"]))
                    state["admit_seq"] += 1
                service_pressure()
                service_starvation()
                if (queue and state["inflight"] == 0
                        and not any(slots_used) and not pending):
                    raise RuntimeError(
                        "cluster stalled with a non-empty queue")
                try:
                    ev = events.get(timeout=_EVENT_TIMEOUT_S)
                except queue_mod.Empty:
                    raise RuntimeError(
                        f"threaded driver: no worker event for "
                        f"{_EVENT_TIMEOUT_S:.0f}s - worker wedged?")
                handle(ev)
                while True:
                    try:
                        handle(events.get_nowait())
                    except queue_mod.Empty:
                        break
        finally:
            for ib in inboxes:
                ib.put(("stop",))
            for w in workers:
                w.join(timeout=60.0)

    def _route_threaded(self, r: Request, slots_used, backlog,
                        per_replica: int) -> int | None:
        """Threaded-driver routing over the coordinator's *tracked* slot
        counts (a worker may not have processed a dispatched admit yet);
        ``session_can_admit`` is the pool-headroom test, safe to read
        cross-thread (the allocator is locked) and advisory - a lost race
        surfaces as admit_retry or pressure, never as corruption."""
        cands = [i for i, e in enumerate(self.engines)
                 if slots_used[i] < per_replica
                 and e.session_can_admit(r)]
        if not cands:
            return None
        if self.router == "round_robin":
            n = len(self.engines)
            for off in range(n):
                i = (self._rr + off) % n
                if i in cands:
                    self._rr = (self._rr + off + 1) % n
                    return i
            raise AssertionError(
                "round_robin scanned every replica without hitting a "
                "candidate despite cands being non-empty - routing "
                "invariant broken")
        if self.router == "least_loaded":
            return min(cands, key=lambda i: (slots_used[i], i))
        return min(cands, key=lambda i: (backlog[i], i))

    def _replica_worker(self, i: int, engine: ServeEngine, inbox, events,
                        stream, dispatch) -> None:
        """Worker loop: the single thread that mutates replica ``i``'s
        session, on its own CUDA ``stream`` (None on the CPU).  Blocks on
        the inbox while drained; while live, drains commands then steps.
        PoolPressure turns into a ("pressure") event plus an inbox wait
        until ("resume",).

        The host work runs under the ``dispatch`` lock, which a worker lets
        go while it waits for its device (``engine.await_device``, before a
        step's tokens are read back) and while it blocks on its inbox.
        CPython runs one thread's Python at a time, and eight workers
        trading that lock op by op ran eight replicas' steps slower than
        the sequential loop; with ``dispatch`` one worker dispatches while
        the others' kernels run.  ``await_device`` returns the seconds it
        waited on the stream and those it then waited for the lock (timed
        only for an attributed replica; attribution counts neither as the
        replica's issue time).  The stream is synchronized before the
        worker exits."""
        stop = False
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())

        def await_device():
            timed = engine.attr.enabled
            dispatch.release()
            try:
                t = engine.clock.now() if timed else 0.0
                if stream is not None:
                    stream.synchronize()
                t_dev = engine.clock.now() if timed else 0.0
            finally:
                dispatch.acquire()
            if not timed:
                return 0.0, 0.0
            return t_dev - t, engine.clock.now() - t_dev
        engine.await_device = await_device
        try:
            with ctx:
                try:
                    while not stop:
                        stop = self._worker_round(i, engine, inbox, events,
                                                  dispatch)
                finally:
                    if stream is not None:
                        stream.synchronize()
        except BaseException as e:
            events.put(("error", i, e))
        finally:
            engine.await_device = None
            events.put(("stopped", i))

    def _worker_round(self, i: int, engine: ServeEngine, inbox, events,
                      dispatch) -> bool:
        """One round of a worker: its commands, then (while live) one
        step, under ``dispatch``.  Returns True on ("stop",)."""
        stop = False
        cmds = []
        if engine.session_active == 0:
            cmds.append(inbox.get())
        while True:
            try:
                cmds.append(inbox.get_nowait())
            except queue_mod.Empty:
                break
        with dispatch:
            for cmd in cmds:
                stop = self._worker_cmd(engine, i, cmd, events) or stop
            if stop or engine.session_active == 0:
                return stop
            while True:
                try:
                    finished = engine.session_step()
                    break
                except PoolPressure as p:
                    rid = next((s.req.rid for j, s
                                in engine.session_slots() if j == p.slot),
                               -1)
                    events.put(("pressure", i, p.slot, rid))
                    dispatch.release()
                    try:
                        while True:
                            cmd = inbox.get()
                            if cmd[0] == "resume":
                                break
                            with dispatch:
                                if self._worker_cmd(engine, i, cmd, events):
                                    return True
                    finally:
                        dispatch.acquire()
        events.put(("step_done", i, finished, engine.session_backlog()))
        return False

    def _worker_cmd(self, engine: ServeEngine, i: int, cmd,
                    events) -> bool:
        """Execute one coordinator command on the worker thread; returns
        True on ("stop",)."""
        kind = cmd[0]
        if kind == "stop":
            return True
        if kind == "admit":
            _, item, aseq = cmd
            seq, order, r, _ready, enq_t = item
            try:
                res = engine.session_admit(r, tag=seq, extra_row=order,
                                           admit_seq=aseq, enqueue_t=enq_t)
            except MemoryError:
                # reserve-mode admission lost a pool race between the
                # coordinator's headroom check and now; bounce it back
                events.put(("admit_retry", i, item, r.rid))
            else:
                events.put(("admitted", i, seq, r.rid, res))
        elif kind == "preempt":
            _, rid = cmd
            slot = next((j for j, s in engine.session_slots()
                         if s.req.rid == rid), None)
            if slot is None:
                events.put(("preempt_miss", i, rid))
            else:
                tag, r2 = engine.session_preempt(slot)
                events.put(("preempted", i, tag, r2))
        # ("resume",) outside a pressure wait: stale, ignore
        return False

    def _aggregate(self, wall: float, registries,
                   extra: MetricsRegistry | None = None) -> EngineStats:
        """Cluster-level EngineStats: *merge* the replicas' metric
        registries (counters add; busy/offered slot-steps give the
        capacity-weighted occupancy) and derive the view from the merged
        registry, so the TTFT/TPOT percentiles are exact over the union of
        every replica's samples.  ``extra`` carries the cluster's own
        scheduler-loop counters."""
        merged = MetricsRegistry()
        for m in registries:
            merged.merge(m)
        if extra is not None:
            merged.merge(extra)
        self.last_metrics = merged
        reps = self.replica_stats
        return EngineStats.from_registry(
            merged, mode="cluster", wall_s=wall,
            kv_layout=self.kv_layout,
            prefill_compiles=sum(s.prefill_compiles for s in reps),
            block_util_peak=(self.pool.stats().peak_utilization
                             if self.pool is not None else 0.0),
            router_policy=self.router, sched_policy=self.policy.name)
