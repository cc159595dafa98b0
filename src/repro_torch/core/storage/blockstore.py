"""The shared block-storage engine under all three stores (paper §3.3–3.4).

One 4 KiB-block I/O layer — ONE :class:`IOStats` definition, ONE
:class:`LRUCache` definition — with per-component partitions, so the
co-located §2.2 baseline, the decoupled vector tier, and the compressed
auxiliary-index tier are all measured on the same ruler (the block), and a
cache budget can be split per component or pooled (`shared_budget` mode,
globally-LRU eviction across partitions).

Component accounting is hierarchical: every component's :class:`IOStats`
chains to the engine total, so ``store.io`` keeps its historical per-store
semantics while ``BlockStore.stats()`` reports the whole engine — the
unification *Optimizing SSD-Resident Graph Indexing* argues the cache and
I/O scheduler need in order to exploit per-component entropy differences.

Canonical component names (shared with ``core/codec/registry.py``):
``adjacency`` (EF adjacency records), ``ef_slots`` (device slot streams),
``pq_codes``, ``vector_chunks`` (compressed vector payload), ``colocated``
(the §2.2 baseline's bundled records).

A copy of ``repro.core.storage.blockstore``: host-side accounting, no
tensors.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from .layout import BLOCK_SIZE

__all__ = ["BLOCK_SIZE", "IOStats", "LRUCache", "SharedBudget",
           "PrefetchQueue", "BlockStore"]


@dataclass
class IOStats:
    """Block-layer read/write counters. ``parent`` chains a component's
    stats into its engine total (reads propagate up, resets stay local)."""
    reads: int = 0
    read_bytes: int = 0
    writes: int = 0
    write_bytes: int = 0
    parent: "IOStats | None" = None

    def read(self, nbytes: int, n: int = 1) -> None:
        self.reads += n
        self.read_bytes += nbytes
        if self.parent is not None:
            self.parent.read(nbytes, n)

    def write(self, nbytes: int, n: int = 1) -> None:
        self.writes += n
        self.write_bytes += nbytes
        if self.parent is not None:
            self.parent.write(nbytes, n)

    def snapshot(self) -> dict:
        return dict(reads=self.reads, read_bytes=self.read_bytes,
                    writes=self.writes, write_bytes=self.write_bytes)


class SharedBudget:
    """One byte budget pooled across several LRU partitions (§3.4 shared
    mode): eviction removes the *globally* least-recently-used entry, so a
    hot component can grow into a cold component's share.

    Per-partition **quota floors** (``LRUCache.floor_bytes``) bound that
    growth for multi-tenant serving: a partition at or below its floor is
    never an eviction victim, so one hot tenant driving misses cannot evict
    a cold tenant's working set below its quota. As long as the floors sum
    to at most the pooled capacity (enforced at registration), some
    partition above its floor always exists whenever the pool is over
    budget, so the byte bound stays hard."""

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = capacity_bytes
        self._members: list["LRUCache"] = []
        self._clock = 0

    def tick(self) -> int:
        self._clock += 1
        return self._clock

    def add(self, cache: "LRUCache") -> None:
        if cache not in self._members:
            self._members.append(cache)

    def release(self, cache: "LRUCache") -> None:
        """Retire a partition (e.g. an old snapshot's clone) from the pool."""
        if cache in self._members:
            self._members.remove(cache)

    @property
    def used_bytes(self) -> int:
        return sum(c.memory_bytes for c in self._members)

    @property
    def hits(self) -> int:
        return sum(c.hits for c in self._members)

    @property
    def misses(self) -> int:
        return sum(c.misses for c in self._members)

    @property
    def floor_bytes(self) -> int:
        return sum(c.floor_bytes for c in self._members)

    def rebalance(self) -> None:
        while self.used_bytes > self.capacity_bytes:
            # Quota floors: a partition at/below its reserved share is not
            # a victim (tenant isolation); floors sum <= capacity, so a
            # victim exists whenever the pool is over budget.
            victims = [c for c in self._members
                       if c._d and c.memory_bytes > c.floor_bytes]
            if not victims:
                break
            # Oldest entry of each partition is its OrderedDict head; the
            # global victim is the one with the smallest recency tick.
            victim = min(victims, key=lambda c: c._tick[next(iter(c._d))])
            victim._evict_oldest()


class LRUCache:
    """Fixed-entry-size LRU (paper §3.4): capacity in entries, every entry
    reserves ``entry_bytes`` regardless of the stored value's actual size.
    Attach a :class:`SharedBudget` to pool the byte budget across several
    partitions (the per-entry recency tick enables global LRU eviction).

    Lookups split three ways under speculative prefetch: ``hits`` (entry
    resident), ``misses`` (a demand block read stalls), and
    ``prefetch_hits`` (entry absent but its block was speculative- or
    buffer-resident — no stall; the owning store reclassifies via
    :meth:`note_prefetch_hit`). ``lookups`` is counted independently so
    ``hits + misses + prefetch_hits == lookups`` is a checkable invariant,
    not a definition."""

    def __init__(self, capacity: int, entry_bytes: int,
                 budget: SharedBudget | None = None, floor_bytes: int = 0):
        self.capacity = capacity
        self.entry_bytes = entry_bytes
        self.floor_bytes = floor_bytes   # shared-budget eviction floor
        self._d: OrderedDict[int, object] = OrderedDict()
        self._tick: dict[int, int] = {}
        self.budget = budget
        if budget is not None:
            budget.add(self)
        self.hits = 0
        self.misses = 0
        self.prefetch_hits = 0
        self.lookups = 0

    def get(self, key: int):
        self.lookups += 1
        if key in self._d:
            self._d.move_to_end(key)
            if self.budget is not None:
                self._tick[key] = self.budget.tick()
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def peek(self, key: int):
        """Non-mutating, non-counted presence probe — prefetch planning
        must not skew hit/miss stats or recency order."""
        return self._d.get(key)

    def note_prefetch_hit(self) -> None:
        """Reclassify the most recent miss as prefetch-served: the record
        was absent from the cache but its 4 KiB block was already resident
        in the speculative read window, so the lookup paid no T_IO stall."""
        self.misses -= 1
        self.prefetch_hits += 1

    def put(self, key: int, value) -> None:
        if self.capacity <= 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        if self.budget is not None:
            self._tick[key] = self.budget.tick()
        while len(self._d) > self.capacity:
            self._evict_oldest()
        if self.budget is not None:
            self.budget.rebalance()

    def _evict_oldest(self) -> None:
        key, _ = self._d.popitem(last=False)
        self._tick.pop(key, None)

    def invalidate(self, keys) -> int:
        """Drop specific entries (incremental merge: only the lists whose
        contents changed are evicted; clean entries stay warm)."""
        n = 0
        for k in keys:
            if self._d.pop(int(k), None) is not None:
                self._tick.pop(int(k), None)
                n += 1
        return n

    def clone(self) -> "LRUCache":
        """Copy for the next snapshot's store: same capacity/entry size,
        same recency order, independent mutation + stats. Under a shared
        budget the clone joins the same pool (retire the original with
        ``budget.release`` once its snapshot is unpinned)."""
        c = LRUCache(self.capacity, self.entry_bytes, budget=self.budget,
                     floor_bytes=self.floor_bytes)
        c._d = OrderedDict(self._d)
        c._tick = dict(self._tick)
        return c

    @property
    def memory_bytes(self) -> int:
        return len(self._d) * self.entry_bytes

    def reset_stats(self) -> None:
        self.hits = self.misses = self.prefetch_hits = self.lookups = 0


class PrefetchQueue:
    """Bounded speculative block-read window (the async prefetch stage of
    the I/O-pipelined beam search).

    The engine issues blocks that hop k+1's *provisional* frontier would
    touch while hop k's distances compute (:meth:`offer`); a later demand
    read finding its block resident (:meth:`take`) skips the T_IO stall.
    Demand reads also enter the window (as already-consumed entries), so
    the queue doubles as a bounded read buffer: a block fetched this hop
    is not re-read for a different record next hop.

    Two bounds keep speculation honest:

    - ``depth``: the residency window holds at most this many blocks
      (FIFO — issuing past it retires the oldest entry, and an
      unconsumed retiree counts as waste).
    - ``budget``: the waste cap per :meth:`drain` interval (one search).
      ``offer`` refuses once ``wasted + outstanding`` would reach it, so
      ``wasted <= budget`` holds at every drain even if every in-flight
      speculation misses.

    Correctness is by construction: the queue only warms residency state
    consulted for *accounting* (stall-or-not); traversal never reads data
    through it, so results are bit-identical with prefetch on or off.
    """

    def __init__(self, depth: int = 8, budget: int = 32):
        if depth <= 0 or budget < 0:
            raise ValueError(f"need depth > 0 and budget >= 0, got "
                             f"depth={depth} budget={budget}")
        self.depth = depth
        self.budget = budget
        self._resident: OrderedDict[int, bool] = OrderedDict()  # key->consumed
        self.issued = 0          # speculative reads issued (lifetime)
        self.hits = 0            # speculations consumed by a demand read
        self.wasted = 0          # speculations never consumed (lifetime)
        self._window_wasted = 0  # waste since the last drain (budget window)

    @property
    def outstanding(self) -> int:
        """Speculative entries not yet consumed by a demand read."""
        return sum(1 for c in self._resident.values() if not c)

    def _retire_oldest(self) -> None:
        _, consumed = self._resident.popitem(last=False)
        if not consumed:
            self.wasted += 1
            self._window_wasted += 1

    def offer(self, key: int) -> bool:
        """Issue a speculative read for ``key`` unless it is already
        resident or the waste budget is exhausted. Returns True when a
        read was issued — the caller accounts the block I/O."""
        key = int(key)
        if key in self._resident:
            return False
        if self._window_wasted + self.outstanding >= self.budget:
            return False              # worst case every in-flight one misses
        self._resident[key] = False
        self.issued += 1
        while len(self._resident) > self.depth:
            self._retire_oldest()
        return True

    def fill(self, key: int) -> None:
        """Record a DEMAND read in the window (already consumed: it can
        satisfy later :meth:`take` calls but never counts as waste)."""
        self._resident[int(key)] = True
        self._resident.move_to_end(int(key))
        while len(self._resident) > self.depth:
            self._retire_oldest()

    def take(self, key: int) -> bool:
        """Demand-side probe: True iff ``key`` is resident (speculative or
        buffered) — the read already happened, no stall. First consumption
        of a speculative entry counts as a prefetch hit."""
        key = int(key)
        if key not in self._resident:
            return False
        if not self._resident[key]:
            self._resident[key] = True
            self.hits += 1
        return True

    def drain(self) -> int:
        """End of one search: unconsumed speculations become waste, the
        window empties, and the per-search waste budget resets. Returns
        the waste charged by this drain."""
        n = 0
        for consumed in self._resident.values():
            if not consumed:
                n += 1
        self.wasted += n
        self._resident.clear()
        self._window_wasted = 0
        return n

    def snapshot(self) -> dict:
        return dict(issued=self.issued, hits=self.hits, wasted=self.wasted,
                    depth=self.depth, budget=self.budget)


class BlockStore:
    """The one block engine: per-component I/O accounting (chained to an
    engine total) + a partitioned LRU pool.

    Stores register a component once and then account every 4 KiB block
    read/write through it — either via the returned per-component
    :class:`IOStats` (historical ``store.io`` attribute) or the
    ``read``/``write`` helpers here. ``shared_budget=True`` pools
    ``cache_bytes`` across all partitions with global-LRU eviction;
    otherwise each partition gets its own ``cache_bytes`` slice.
    """

    def __init__(self, cache_bytes: int = 0, shared_budget: bool = False):
        self.io = IOStats()
        self.cache_bytes = cache_bytes
        self.budget = SharedBudget(cache_bytes) if shared_budget else None
        self.components: dict[str, IOStats] = {}
        self.partitions: dict[str, LRUCache] = {}
        self.prefetch_queues: dict[str, PrefetchQueue] = {}

    # ----------------------------------------------------------- components
    def component_io(self, name: str) -> IOStats:
        """The (persistent) per-component stats, chained to the total."""
        if name not in self.components:
            self.components[name] = IOStats(parent=self.io)
        return self.components[name]

    def fresh_io(self, name: str) -> IOStats:
        """A FRESH per-component stats object (still chained to the total).
        The §3.5 merge path uses this so each published store carries only
        its own merge's writes while the engine total keeps accumulating."""
        self.components[name] = IOStats(parent=self.io)
        return self.components[name]

    def adopt(self, name: str, io: IOStats) -> IOStats:
        """Chain an existing store's stats into this engine (re-parents the
        child; its past counters stay local, future traffic aggregates)."""
        io.parent = self.io
        self.components[name] = io
        return io

    def register_cache(self, name: str, entry_bytes: int,
                       cache_bytes: int | None = None,
                       floor_bytes: int = 0) -> LRUCache:
        """Create a component's cache partition. Always FRESH: a rebuilt
        store must never share a live partition with the store an in-flight
        snapshot still reads (clone() is the warm-handover path). The
        previous partition, if any, leaves the shared pool. Capacity is
        bounded by the pooled budget in shared mode, else by this
        partition's own ``cache_bytes`` slice.

        ``floor_bytes`` (shared-budget mode) reserves a per-partition quota
        floor: global-LRU eviction never shrinks this partition below it.
        Floors must fit the pooled budget — over-committing would make the
        byte bound soft, so it raises instead."""
        budget_bytes = self.cache_bytes if cache_bytes is None else cache_bytes
        cap = budget_bytes // max(1, entry_bytes)
        existing = self.partitions.get(name)
        if floor_bytes and self.budget is not None:
            # Validate BEFORE mutating budget state: a rejected
            # registration must leave the existing partition installed AND
            # tracked. The existing partition's floor is excluded — it is
            # the one being replaced.
            prior = (existing.floor_bytes
                     if existing is not None
                     and existing in self.budget._members else 0)
            reserved = self.budget.floor_bytes - prior + floor_bytes
            if reserved > self.budget.capacity_bytes:
                raise ValueError(
                    f"cache floors over-commit the shared budget: "
                    f"{reserved} reserved > {self.budget.capacity_bytes} "
                    f"pooled (registering {name!r})")
        if existing is not None and self.budget is not None:
            self.budget.release(existing)
        c = LRUCache(cap, entry_bytes, budget=self.budget,
                     floor_bytes=floor_bytes if self.budget is not None else 0)
        self.partitions[name] = c
        return c

    def register_tenant_cache(self, tenant: str, entry_bytes: int,
                              floor_bytes: int = 0) -> LRUCache:
        """A tenant's LRU partition under the canonical ``tenant:<name>``
        component key (multi-tenant serving: one partition per tenant, all
        drawing on the shared budget, eviction bounded by the tenant's
        quota floor)."""
        return self.register_cache(f"tenant:{tenant}", entry_bytes,
                                   floor_bytes=floor_bytes)

    def register_prefetch(self, name: str, depth: int = 8,
                          budget: int = 32) -> PrefetchQueue:
        """The component's speculative-read window. Idempotent for
        unchanged bounds (the engine enables prefetch per search config,
        and re-enabling must not reset lifetime counters); changed bounds
        install a fresh queue."""
        q = self.prefetch_queues.get(name)
        if q is not None and (q.depth, q.budget) == (depth, budget):
            return q
        q = PrefetchQueue(depth, budget)
        self.prefetch_queues[name] = q
        return q

    def replace_cache(self, name: str, cache: LRUCache) -> LRUCache:
        """Install an externally-built partition (e.g. the ``clone()`` an
        incremental merge hands the published store) as the component's
        current cache; the previous partition leaves the shared pool."""
        old = self.partitions.get(name)
        if old is not None and old is not cache and self.budget is not None:
            self.budget.release(old)
        self.partitions[name] = cache
        return cache

    # ------------------------------------------------------------ accounting
    def read(self, component: str, nbytes: int = BLOCK_SIZE, n: int = 1) -> None:
        self.component_io(component).read(nbytes, n)

    def write(self, component: str, nbytes: int, n: int = 1) -> None:
        self.component_io(component).write(nbytes, n)

    # --------------------------------------------------------------- metrics
    def cache_stats(self) -> dict:
        """Totals + per-partition hit/miss/bytes. In shared-budget mode the
        invariant ``total hits+misses == sum(partition hits+misses)`` holds
        by construction — the partitions ARE the pool's members."""
        per = {name: dict(hits=c.hits, misses=c.misses,
                          prefetch_hits=c.prefetch_hits, lookups=c.lookups,
                          memory_bytes=c.memory_bytes)
               for name, c in self.partitions.items()}
        return dict(
            hits=sum(p["hits"] for p in per.values()),
            misses=sum(p["misses"] for p in per.values()),
            prefetch_hits=sum(p["prefetch_hits"] for p in per.values()),
            lookups=sum(p["lookups"] for p in per.values()),
            memory_bytes=sum(p["memory_bytes"] for p in per.values()),
            shared_budget=self.budget is not None,
            budget_bytes=self.cache_bytes,
            partitions=per)

    def prefetch_stats(self) -> dict:
        """Per-component speculative-read counters (hit rate = consumed
        speculations / issued — the bench's per-component report)."""
        return {name: q.snapshot()
                for name, q in self.prefetch_queues.items()}

    def stats(self) -> dict:
        return dict(total=self.io.snapshot(),
                    components={n: s.snapshot()
                                for n, s in self.components.items()},
                    cache=self.cache_stats(),
                    prefetch=self.prefetch_stats())
