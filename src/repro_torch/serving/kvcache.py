"""Paged KV-cache subsystem: block allocator + device-side table helpers.

The port's counterpart of ``repro/serving/kvcache.py``: the host-side
allocator is a copy; the device helpers at the end update the cache's
tensors in place instead of returning new arrays.

The serving analog of Ara2's memory-subsystem finding (bottleneck analysis:
memory organization, not raw FPU count, gates utilization): the dense slot
pool reserves ``cache_len`` KV positions per slot no matter how short the
request, so admission is bounded by worst-case reservation.  Paging (vLLM's
PagedAttention, Kwon et al. SOSP 2023) splits the KV cache into fixed-size
blocks drawn from one global pool:

* ``BlockAllocator`` - a host-side free list over ``n_blocks`` pool blocks.
  Block 0 is reserved as the *null block*: freed/idle decode slots point
  every block-table entry at it, so their stale one-token writes land in a
  scratch block instead of corrupting a live request's KV.

  The allocator is a first-class object that can be *shared*: a
  multi-replica cluster (``repro.serving.cluster``) constructs one pool and
  passes it to every ``ServeEngine`` replica, the serving analog of Ara2's
  multi-core clusters sharing one L2 - each core (replica) issues its own
  stream but draws from common memory.  Two features support sharing:

  - **per-owner accounting**: every live block is tagged with the owner id
    passed to ``alloc``/``alloc_n`` (a replica index), so the cluster can
    see which replica holds what (``live_by_owner``).
  - **pool-level reservations**: engines running ``admission="reserve"``
    promise worst-case blocks at admit time via ``reserve``/``unreserve``;
    the reservation count lives here (not per engine) so co-tenant engines
    see each other's promises and lazy growth can never fail.  Allocations
    that convert a standing promise into a live block pass
    ``from_reservation=True``; every *other* allocation (an atomic
    ``alloc_n``, an overcommit growth) gates on ``n_avail`` - the free
    blocks **not** spoken for - so it can never eat another request's
    promised blocks.  Engines running ``admission="overcommit"`` skip
    reservations; their lazy growth *can* find the pool empty, which
    surfaces as ``PoolPressure`` and is resolved by the cluster preempting
    a victim request.

* **refcounted sharing + prefix index** (prefix caching): a block may be
  held by several requests at once (``incref``/``refcount``); ``free``
  decrements and only a block whose last reference drops actually leaves
  the live set.  Full prompt-prefix blocks are *registered* under an
  exact chain key - ``(parent_key, tuple(span_token_ids))``, nested so a
  block's identity covers every token before it, with no integer-hash
  collisions by construction - and a later admission with the same
  prefix ``lookup``s resident blocks and re-references them instead of
  re-prefilling.  A registered block whose refcount drops to 0 is not
  returned to the free list immediately: it parks in a **cached** LRU
  set, still indexed (a future hit revives it via ``incref``) but also
  still *evictable* - ``alloc`` falls back to evicting the
  least-recently-used cached block once the raw free list is empty, so
  caching never shrinks the pool: ``n_free`` counts free + cached and
  the conservation invariant stays exact.  Because each replica writes
  its own device-side pool arrays (see ``repro.serving.cluster``), index
  entries are tagged with the *writer* owner and ``lookup`` only returns
  blocks whose bytes live where the reader can gather them.

* per-request **block tables** - ordered rows of block ids mapping logical
  KV positions ``[i * block_size, (i+1) * block_size)`` to pool blocks.
  Rows live in the device cache (``pcache["bt"]``) so the decode kernel can
  gather them; ownership/accounting lives here on the host.

The pool layout itself ((n_layers, n_blocks, n_kv_heads, block_size,
head_dim)) is built by the model family (``model.paged_cache_init``); this
module only manages block ownership and the layout-agnostic table/position
updates shared by every paged family (including ``pool_copy_block``, the
device-side block copy backing copy-on-write divergence).

**Conservation invariants** (asserted by the stateful allocator property
in ``tests/test_kvcache.py`` (reference) and after every run of the conformance
suite in ``tests/test_serving_props.py``): a block is never handed out
twice, never freed below refcount 0, never freed by a non-holder;
``n_live + n_free == capacity`` at all times (``n_free`` counting cached
blocks); ``sum(refcounts) >= n_live``; reservations never exceed
unreserved-free blocks; ``free`` is atomic (a rejected list mutates
nothing); and after any ``generate`` — including one aborted by an
exception — the pool drains to ``n_live == 0``, ``n_reserved == 0``,
``n_free == capacity``.

**Thread safety**: every public method and property takes the
allocator's internal re-entrant lock, so concurrent replicas (the
threaded cluster driver steps each replica in its own worker thread)
can alloc/free/register/lookup against the shared pool without torn
state; ``check_integrity`` holds the same lock, so it always sees a
consistent snapshot.  Compound check-then-act sequences (resolve prefix
hits, reserve, then apply the hits) are made atomic by holding
``allocator.lock`` across the whole sequence — the lock is re-entrant
precisely so callers can wrap multiple calls.  Asserted by the
multi-threaded stress variant of the allocator rule machine in
``tests/test_kvcache.py`` (reference).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any

from .telemetry import NULL_TRACER

NULL_BLOCK = 0


class PoolPressure(MemoryError):
    """Lazy block growth found the (shared) pool empty under overcommit
    admission.  Carries the requesting owner and decode slot so a cluster
    scheduler can pick a preemption victim and retry the step."""

    def __init__(self, owner, slot: int):
        super().__init__(
            f"KV block pool exhausted under overcommit (owner={owner}, "
            f"slot={slot}): preempt a request or grow the pool")
        self.owner = owner
        self.slot = slot


def blocks_needed(n_positions: int, block_size: int) -> int:
    """Number of KV blocks covering ``n_positions`` cache positions."""
    return -(-n_positions // block_size)


def prefix_chain_keys(tokens, block_size: int) -> list:
    """Exact chain keys for every *full* ``block_size`` span of ``tokens``.

    Key ``i`` is ``(key_{i-1}, tuple(span_i))`` (root parent ``None``), so
    a block's key covers every token before it and equal keys imply equal
    full prefixes - token-exact, no integer-hash collision class (the
    historic prefix-cache corruption bug category)."""
    keys = []
    parent = None
    for i in range(len(tokens) // block_size):
        span = tuple(tokens[i * block_size:(i + 1) * block_size])
        parent = (parent, span)
        keys.append(parent)
    return keys


@dataclasses.dataclass(frozen=True)
class BlockPoolStats:
    n_blocks: int                  # pool size including the null block
    block_size: int
    capacity: int                  # allocatable blocks (null excluded)
    n_live: int
    n_free: int                    # free-list + cached (reusable) blocks
    peak_live: int
    utilization: float             # n_live / capacity
    peak_utilization: float        # peak_live / capacity
    n_reserved: int = 0            # worst-case blocks promised, not yet live
    n_cached: int = 0              # refcount-0 blocks still prefix-indexed


class BlockAllocator:
    """Free-list allocator over a global pool of fixed-size KV blocks.

    Freed blocks are reused LIFO (most recently freed first), which keeps
    hot pool regions hot; refcount-0 *registered* blocks are evicted
    LRU-last, only after the raw free list is empty.  Block 0
    (``NULL_BLOCK``) is never handed out.
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError(
                f"n_blocks={n_blocks}: need at least the null block plus "
                "one allocatable block")
        if block_size < 1:
            raise ValueError(f"block_size={block_size} must be >= 1")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._policy: str | None = None
        self._tracer = NULL_TRACER
        # Re-entrant: public methods call each other (alloc -> unreserve,
        # alloc_n -> alloc, take_cached -> unreserve) and engines hold it
        # across compound admission sequences.
        self._lock = threading.RLock()
        self.reset()

    @property
    def lock(self) -> threading.RLock:
        """The allocator's re-entrant lock.  Hold it across compound
        check-then-act sequences (e.g. prefix-hit resolution followed by
        ``reserve`` + ``take_cached``/``incref``) that must be atomic
        against co-tenant engines in other threads."""
        return self._lock

    # -- telemetry -----------------------------------------------------

    def set_tracer(self, tracer) -> None:
        """Attach a tracer: pool mutations emit a ``blocks`` counter
        series (free / live / reserved / cached — the free-block
        watermark timeline in the trace) and reservation instants on the
        ``pool`` track.  Host-side only; no device state involved."""
        self._tracer = tracer if tracer is not None else NULL_TRACER

    def _trace_watermark(self) -> None:
        if self._tracer.enabled:
            self._tracer.counter("pool", "blocks", free=len(self._free),
                                 live=self.n_live, reserved=self._reserved,
                                 cached=self.n_cached)

    def claim_policy(self, policy: str) -> None:
        """Engines sharing this pool must agree on one admission policy:
        overcommit growth spends free blocks without consulting
        reservations, so mixing it with a reserve-admission co-tenant
        would break the latter's growth-never-fails guarantee."""
        if self._policy is None:
            self._policy = policy
        elif self._policy != policy:
            raise ValueError(
                f"pool already serves admission={self._policy!r} engines; "
                f"a co-tenant requested admission={policy!r} (mixed "
                "policies would let overcommit growth eat reserved blocks)")

    # -- lifecycle -----------------------------------------------------

    def reset(self) -> None:
        """Return every block to the free list and clear stats + index."""
        with self._lock:
            # stacked so that pop() hands out 1, 2, 3, ... on a fresh pool
            self._free = list(range(self.n_blocks - 1, 0, -1))
            self._live: dict[int, list] = {}  # block id -> owners (multiset)
            self._reserved = 0
            self._peak = 0
            # prefix cache: chain key -> (block id, writer owner); block id
            # -> chain key (reverse, for eviction/unregister); LRU of
            # refcount-0 registered blocks (oldest-first, still allocatable)
            self._index: dict[Any, tuple[int, Any]] = {}
            self._key_of: dict[int, Any] = {}
            self._cached: collections.OrderedDict[int, None] = \
                collections.OrderedDict()

    def reset_peak(self) -> None:
        with self._lock:
            self._peak = len(self._live)

    # -- alloc / free --------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.n_blocks - 1

    @property
    def n_free(self) -> int:
        """Blocks allocatable right now: the raw free list plus cached
        (refcount-0, still prefix-indexed) blocks, which ``alloc`` evicts
        LRU-first once the free list is empty."""
        with self._lock:
            return len(self._free) + len(self._cached)

    @property
    def n_live(self) -> int:
        with self._lock:
            return len(self._live)

    @property
    def n_reserved(self) -> int:
        with self._lock:
            return self._reserved

    @property
    def n_cached(self) -> int:
        """Refcount-0 blocks kept for prefix reuse (subset of n_free)."""
        with self._lock:
            return len(self._cached)

    @property
    def n_avail(self) -> int:
        """Free blocks not spoken for by a standing reservation."""
        with self._lock:
            return self.n_free - self._reserved

    def _pop_free(self) -> int:
        """Take a block off the raw free list, evicting the LRU cached
        block (dropping its index entry) when the list is empty."""
        if self._free:
            return self._free.pop()
        blk, _ = self._cached.popitem(last=False)   # LRU-first eviction
        self._drop_index(blk)
        return blk

    def _drop_index(self, blk: int) -> None:
        key = self._key_of.pop(blk, None)
        if key is not None and self._index.get(key, (None,))[0] == blk:
            del self._index[key]

    def alloc(self, owner=0, *, from_reservation: bool = False) -> int:
        """Hand out one block.  ``from_reservation=True`` converts one of
        the caller's standing promises into a live block (``reserve`` was
        already charged, so the promised block is free by construction and
        the reservation count drops here); otherwise the allocation gates
        on ``n_avail`` so it can never eat a block promised to another
        request's lazy growth."""
        with self._lock:
            budget = self.n_free if from_reservation else self.n_avail
            if budget < 1:
                raise MemoryError(
                    f"KV block pool exhausted ({self.capacity} blocks of "
                    f"{self.block_size} positions: {self.n_live} live, "
                    f"{self._reserved} reserved)")
            blk = self._pop_free()
            self._live[blk] = [owner]
            self._peak = max(self._peak, len(self._live))
            if from_reservation:
                self.unreserve(1)
            self._trace_watermark()
            return blk

    def alloc_n(self, n: int, owner=0, *,
                from_reservation: bool = False) -> list[int]:
        """Allocate ``n`` blocks atomically (all or nothing).  Gates on
        ``n_avail`` unless the caller holds a matching reservation - an
        atomic admission must not consume blocks promised to another
        request's growth."""
        with self._lock:
            budget = self.n_free if from_reservation else self.n_avail
            if n > budget:
                raise MemoryError(
                    f"KV block pool exhausted: need {n} blocks, "
                    f"{budget}/{self.capacity} "
                    + ("free" if from_reservation else "unreserved-free"))
            return [self.alloc(owner, from_reservation=from_reservation)
                    for _ in range(n)]

    def free(self, blocks, owner=0) -> None:
        """Drop one reference per listed block, atomically: the whole list
        is validated against the live set (and this owner's holdings)
        before any mutation, so a rejected call leaves the pool exactly as
        it was.  A block whose last reference drops returns to the free
        list - unless it is prefix-registered, in which case it parks in
        the cached LRU (still indexed, still allocatable)."""
        blocks = list(blocks)
        with self._lock:
            pending = collections.Counter()
            for blk in blocks:
                if blk not in self._live:
                    raise ValueError(
                        f"free of block {blk} which is not live "
                        "(double free or foreign id)")
                pending[blk] += 1
                if pending[blk] > self._live[blk].count(owner):
                    raise ValueError(
                        f"free of block {blk} by owner {owner!r} which "
                        f"holds {self._live[blk].count(owner)} of its "
                        f"{len(self._live[blk])} references")
            for blk in blocks:
                self._live[blk].remove(owner)
                if self._live[blk]:
                    continue                  # other holders remain
                del self._live[blk]
                if blk in self._key_of:
                    self._cached[blk] = None  # newest = evicted last
                    self._cached.move_to_end(blk)
                else:
                    self._free.append(blk)
            self._trace_watermark()

    # -- prefix index (refcounted content-addressed blocks) ------------

    def incref(self, blk: int, owner=0) -> None:
        """Add a reference to an already-live block (prefix-cache hit on a
        block another request currently holds)."""
        with self._lock:
            if blk not in self._live:
                raise ValueError(f"incref of block {blk} which is not live")
            self._live[blk].append(owner)

    def refcount(self, blk: int) -> int:
        with self._lock:
            return len(self._live.get(blk, ()))

    def is_cached(self, blk: int) -> bool:
        """True for a refcount-0 block parked in the cached LRU (a hit on
        it must ``take_cached`` rather than ``incref``)."""
        with self._lock:
            return blk in self._cached

    def register(self, key, blk: int, owner=0) -> None:
        """Publish live block ``blk`` under prefix chain ``key``.  Last
        writer wins (two requests racing the same cold prefix both write
        correct bytes; the index just points at one of them).  The entry
        is tagged with the *writer* owner: device pools are per-replica,
        so only readers whose gathers address the writer's pool may hit."""
        with self._lock:
            if blk not in self._live:
                raise ValueError(
                    f"register of block {blk} which is not live")
            prev = self._index.get(key)
            if prev is not None and prev[0] != blk:
                self._key_of.pop(prev[0], None)
                if prev[0] in self._cached:   # superseded cached copy:
                    self._cached.pop(prev[0])  # plain free block again
                    self._free.append(prev[0])
            stale = self._key_of.get(blk)
            if stale is not None and stale != key:
                # block re-used for different content (COW rewrite of a
                # refcount-1 block): the old chain entry is dead
                if self._index.get(stale, (None,))[0] == blk:
                    del self._index[stale]
            self._index[key] = (blk, owner)
            self._key_of[blk] = key

    def lookup(self, key, owner=0):
        """Resolve a prefix chain key to a resident block id, or None.
        Only blocks *written* by ``owner`` hit (per-replica device pools);
        a cached (refcount-0) block is a valid hit - ``incref`` it via
        ``take_cached`` to revive it."""
        with self._lock:
            ent = self._index.get(key)
            if ent is None or ent[1] != owner:
                return None
            blk = ent[0]
            if blk in self._live or blk in self._cached:
                return blk
            return None

    def take_cached(self, blk: int, owner=0, *,
                    from_reservation: bool = False) -> None:
        """Revive a cached (refcount-0) block into the live set for a hit.
        Costs one allocatable block, so it follows ``alloc``'s gating:
        reservation-backed revivals spend a promise, others spend
        ``n_avail``."""
        with self._lock:
            if blk not in self._cached:
                raise ValueError(f"block {blk} is not cached")
            budget = self.n_free if from_reservation else self.n_avail
            if budget < 1:
                raise MemoryError(
                    f"KV block pool exhausted ({self.capacity} blocks: "
                    f"{self.n_live} live, {self._reserved} reserved)")
            self._cached.pop(blk)
            self._live[blk] = [owner]
            self._peak = max(self._peak, len(self._live))
            if from_reservation:
                self.unreserve(1)
            self._trace_watermark()

    def flush_index(self, owner=None) -> int:
        """Drop prefix-index entries (all, or one writer's) - cached
        blocks return to the raw free list, live blocks stay live but
        stop being discoverable.  Used when a writer's device pool is
        torn down (its registered bytes no longer exist).  Returns the
        number of entries dropped."""
        with self._lock:
            keys = [k for k, (_, o) in self._index.items()
                    if owner is None or o == owner]
            for k in keys:
                blk, _ = self._index.pop(k)
                self._key_of.pop(blk, None)
                if blk in self._cached:
                    self._cached.pop(blk)
                    self._free.append(blk)
            return len(keys)

    def check_integrity(self) -> None:
        """Assert the conservation invariants (test hook; cheap enough for
        per-step use in property suites).  Holds the allocator lock, so
        the snapshot it checks is consistent even mid-traffic."""
        with self._lock:
            assert not (set(self._live) & set(self._free)), "live∩free"
            assert not (set(self._live) & set(self._cached)), "live∩cached"
            assert not (set(self._cached) & set(self._free)), "cached∩free"
            assert NULL_BLOCK not in self._live and \
                NULL_BLOCK not in self._free and \
                NULL_BLOCK not in self._cached, "null block escaped"
            total = len(self._live) + len(self._free) + len(self._cached)
            assert total == self.capacity, \
                f"conservation: {len(self._live)} live + " \
                f"{len(self._free)} free + {len(self._cached)} cached " \
                f"!= {self.capacity}"
            assert all(len(o) >= 1 for o in self._live.values()), \
                "live block with no holders"
            assert sum(len(o) for o in self._live.values()) >= \
                self.n_live, "sum(refs) < n_live"
            assert self._reserved >= 0
            assert self._reserved <= self.n_free, \
                "reservations exceed free"
            for blk in self._cached:
                assert blk in self._key_of, \
                    "cached block lost its index key"
            for key, (blk, _) in self._index.items():
                assert self._key_of.get(blk) == key, \
                    "index/key_of mismatch"
            if self._tracer.enabled:
                self._tracer.instant("pool", "integrity_ok",
                                     live=self.n_live, free=self.n_free,
                                     reserved=self._reserved)

    # -- reservations (worst-case admission promises) ------------------

    def reserve(self, n: int) -> None:
        """Promise ``n`` free blocks to an admitted request's future lazy
        growth.  Pool-level so co-tenant engines see each other's promises;
        ``n_avail`` is what admission may still spend."""
        with self._lock:
            if n > self.n_avail:
                raise MemoryError(
                    f"cannot reserve {n} blocks: only {self.n_avail} of "
                    f"{self.capacity} unreserved-free")
            self._reserved += n
            if self._tracer.enabled and n:
                self._tracer.instant("pool", "reserve", n=n)
            self._trace_watermark()

    def unreserve(self, n: int) -> None:
        """Release reservations (a promised block became live, or its
        request finished / was preempted)."""
        with self._lock:
            if n > self._reserved:
                raise ValueError(
                    f"unreserve({n}) exceeds standing reservations "
                    f"({self._reserved})")
            self._reserved -= n
            if n:
                self._trace_watermark()

    # -- accounting ----------------------------------------------------

    def live_by_owner(self) -> dict:
        """Live block-reference counts per owner (a cluster's per-replica
        view; a shared block counts once per holding owner)."""
        with self._lock:
            counts: dict = {}
            for owners in self._live.values():
                for owner in owners:
                    counts[owner] = counts.get(owner, 0) + 1
            return counts

    def owner_of(self, blk: int):
        """First holder of a live block (sole holder for unshared blocks)."""
        with self._lock:
            return self._live[blk][0]

    def stats(self) -> BlockPoolStats:
        with self._lock:
            cap = self.capacity
            return BlockPoolStats(
                self.n_blocks, self.block_size, cap, self.n_live,
                self.n_free, self._peak, self.n_live / cap,
                self._peak / cap, n_reserved=self._reserved,
                n_cached=self.n_cached)


# ---------------------------------------------------------------------------
# Device-side block-table updates (layout-agnostic, in place).
#
# Every paged cache dict carries "bt" (B, max_blocks) int32 block tables and
# "pos" (B,) int32 per-slot positions next to its model-specific pools.
# ---------------------------------------------------------------------------

def bt_set_entry(pcache: dict, slot: int, idx: int, block: int) -> dict:
    """Install pool block ``block`` as entry ``idx`` of ``slot``'s block
    table (lazy growth: called when a slot's position enters a new block)."""
    pcache["bt"][slot, idx] = block
    return pcache


def slot_release(pcache: dict, slot: int) -> dict:
    """Point a freed slot's whole block table at the null block and reset
    its position, so idle decode writes land in scratch, never in a block
    that has been recycled to another request."""
    pcache["bt"][slot] = NULL_BLOCK
    pcache["pos"][slot] = 0
    return pcache


def pool_copy_block(pcache: dict, dst: int, src: int) -> dict:
    """Copy pool block ``src``'s bytes into block ``dst`` in every pool
    leaf (copy-on-write divergence).  Pool leaves are
    ``(L, n_blocks, ...)`` with the block axis at position 1; the
    ``bt``/``pos`` tables are left untouched."""
    for name, leaf in pcache.items():
        if name in ("bt", "pos"):
            continue
        leaf[:, dst] = leaf[:, src]
    return pcache
