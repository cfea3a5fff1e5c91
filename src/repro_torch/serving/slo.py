"""SLO-aware scheduling policies: admission order, victim ranking, and
starvation pressure from per-request latency budgets.

A pure-Python copy of the reference's ``repro/serving/slo.py`` (the
reference's ``serving`` package imports JAX, so the port keeps its own).
The port's ``ServeEngine`` uses the admission order and the victim
ranking, and its ``ClusterEngine`` the routing and starvation signal too.

Every knob the scheduler had before this module was static: admission
was strictly FIFO, preemption victims were picked by (priority,
-admit_seq), and the only pressure signal in the system was the paged
pool's :class:`~repro_torch.serving.kvcache.PoolPressure` — dense and
scan-family replicas never felt pressure at all, so a long best-effort
request could sit on a slot forever while short interactive requests
aged in the queue.  That is the serving twin of Ara2's §6 finding: the
*issue policy*, not the raw FPU count, gates utilization in the
short-workload regime.

This module adds the missing signal and the policies that act on it:

* **budgets** — :class:`~repro_torch.serving.engine.Request` carries
  ``slo_ttft_ms`` (enqueue → first token) and ``slo_tpot_ms`` (decode
  ms per output token).  Both default to ``None`` = best-effort; a
  request with neither budget behaves exactly as before.

* **policies** (``POLICIES``) — pluggable :class:`SchedPolicy`
  strategies threaded through ``ServeEngine`` (admission reorder),
  ``ClusterEngine`` (routing, victim pick, both drivers), and
  ``launch.serve`` (``--policy``):

  - ``fifo``          — strict arrival order, head-of-line blocking
                        (byte-for-byte today's behavior);
  - ``priority``      — highest ``Request.priority`` first, FIFO ties;
  - ``edf``           — earliest TTFT deadline first; best-effort
                        requests (deadline = +inf) stay FIFO behind
                        every budgeted one;
  - ``slo_adaptive``  — EDF admission **plus** deadline-aware victim
                        ranking (a budgeted request inside its slack is
                        *protected*: never evicted while a best-effort
                        victim exists), slack-aware routing (budgeted
                        requests go to the emptiest replica), and the
                        **starvation pressure signal**: when no replica
                        has a free slot (slot-count signal) and the most
                        urgent queued request's remaining TTFT slack has
                        fallen inside the guard band (queue-age signal),
                        the cluster preempts an unprotected victim —
                        this is how dense/scan replicas, which can never
                        raise ``PoolPressure``, finally feel pressure.

Correctness contract (asserted across the conformance matrix in
``tests/test_serving_props.py``): with no budgets set every policy's
token output is byte-identical to FIFO — ``edf``/``slo_adaptive`` keys
degenerate to arrival order when every deadline is +inf, and
request-keyed sampling makes token streams a pure function of
(rid, token index) regardless of admission order; with budgets set the
per-request streams are *still* byte-identical — policies reorder,
never alter, sampling.

All scoring here is host-side arithmetic over the injectable clock
(``telemetry.FakeClock`` makes starvation tests deterministic); no
compiled function depends on a policy, so a warm engine keeps its
caches when the policy changes.
"""
from __future__ import annotations

POLICIES = ("fifo", "priority", "edf", "slo_adaptive")

_INF = float("inf")


def ttft_deadline(req, enqueue_t: float) -> float:
    """Absolute first-token deadline (clock seconds) of ``req`` enqueued
    at ``enqueue_t``; +inf for a best-effort request (no TTFT budget)."""
    if req.slo_ttft_ms is None:
        return _INF
    return enqueue_t + req.slo_ttft_ms / 1e3


def slo_budget_s(req) -> float | None:
    """Whole-request latency window (seconds): TTFT budget plus the TPOT
    budget over the tokens still owed.  None when best-effort."""
    if req.slo_ttft_ms is None and req.slo_tpot_ms is None:
        return None
    owed = max(req.max_new_tokens - len(req.done), 0)
    return ((req.slo_ttft_ms or 0.0) + (req.slo_tpot_ms or 0.0) * owed) / 1e3


def in_slack(req, t0: float, now: float) -> bool:
    """True while a budgeted request served since ``t0`` is inside its
    whole-request latency window — the *protected* state: an SLO-aware
    victim pick must not evict it while a best-effort victim exists.
    Best-effort requests are never in slack (always evictable first)."""
    budget = slo_budget_s(req)
    return budget is not None and (now - t0) < budget


class SchedPolicy:
    """Base scheduling strategy; the concrete policies override keys.

    Key contracts (all pure, host-side, evaluated at one ``now`` per
    scheduling decision so comparisons are consistent):

    * ``order_key(seq, req, enqueue_t, now)`` — admission order; the
      queued item with the *minimum* key is admitted next.  Ties fall
      back to ``seq`` (arrival order), so keys must embed it.
    * ``victim_key(req, admit_seq, t0, now)`` — preemption ranking over
      live requests; the *minimum* key is evicted first.  The leading
      element is the protection flag (0 = evictable, 1 = inside its
      deadline slack), so a protected request is only ever chosen when
      no unprotected candidate exists — the bugfix regression in
      ``tests/test_slo.py`` pins this.
    * ``starving(req, enqueue_t, now, guard_s)`` — the queue-age half of
      the dense/scan pressure signal: True once the queued request's
      remaining TTFT slack is inside the guard band.

    Flags: ``reorders`` — admission picks min(order_key) over ready
    items instead of the FIFO head (and may skip past a cooling-down
    victim); ``preempts_on_starvation`` — the cluster drivers arm the
    slot-count + queue-age pressure signal; ``slack_routes`` — budgeted
    requests route to the emptiest replica regardless of the configured
    router (best-effort traffic keeps the configured policy).
    """

    name = "fifo"
    reorders = False
    preempts_on_starvation = False
    slack_routes = False

    def order_key(self, seq: int, req, enqueue_t: float, now: float):
        return (0.0, seq)

    def victim_key(self, req, admit_seq: int, t0: float, now: float):
        # classic ranking: lowest priority, then youngest admission
        return (0, req.priority, -admit_seq)

    def starving(self, req, enqueue_t: float, now: float,
                 guard_s: float) -> bool:
        return False

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


class FifoPolicy(SchedPolicy):
    """Strict arrival order with head-of-line blocking — byte-for-byte
    the pre-policy scheduler (the conformance reference)."""

    name = "fifo"


class PriorityPolicy(SchedPolicy):
    """Highest ``Request.priority`` admitted first; arrival order breaks
    ties.  Victim ranking is unchanged (lowest priority evicted first),
    so priority is honored symmetrically at admission and eviction."""

    name = "priority"
    reorders = True

    def order_key(self, seq, req, enqueue_t, now):
        return (float(-req.priority), seq)


class EdfPolicy(SchedPolicy):
    """Earliest-deadline-first admission over the TTFT deadline.
    Best-effort requests (deadline +inf) stay FIFO among themselves
    behind every budgeted request; with no budgets anywhere the key
    degenerates to arrival order (≡ FIFO)."""

    name = "edf"
    reorders = True

    def order_key(self, seq, req, enqueue_t, now):
        return (ttft_deadline(req, enqueue_t), seq)


class SloAdaptivePolicy(EdfPolicy):
    """EDF admission plus the adaptive halves: deadline-aware victim
    protection, slack-aware routing, and the starvation pressure signal
    for replicas that can never raise ``PoolPressure`` (dense/scan).
    See the module doc for the full semantics."""

    name = "slo_adaptive"
    preempts_on_starvation = True
    slack_routes = True

    def victim_key(self, req, admit_seq, t0, now):
        return (int(in_slack(req, t0, now)), req.priority, -admit_seq)

    def starving(self, req, enqueue_t, now, guard_s):
        deadline = ttft_deadline(req, enqueue_t)
        return deadline < _INF and deadline - now <= guard_s


_REGISTRY = {p.name: p for p in (FifoPolicy, PriorityPolicy, EdfPolicy,
                                 SloAdaptivePolicy)}


def make_policy(policy) -> SchedPolicy:
    """Resolve ``policy`` to a :class:`SchedPolicy` instance: a name
    from ``POLICIES``, or an instance passed through (custom policies
    plug in by subclassing)."""
    if isinstance(policy, SchedPolicy):
        return policy
    if policy not in _REGISTRY:
        raise ValueError(f"policy={policy!r}: pick one of {POLICIES} "
                         "(or pass a SchedPolicy instance)")
    return _REGISTRY[policy]()
