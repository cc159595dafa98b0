"""SLO-aware admission tier for multi-tenant serving — the port of
``repro.serve.admission``.

``BatchedSearcher`` (``serve/ann.py``) is call-driven: callers hand it a
batch. This module is the front that *forms* those batches from an
open-loop request stream:

1. **Open-loop queue on a simulated clock.** Requests carry
   ``(tenant, arrival_us, deadline_us)``; the loop replays them in
   simulated-time order. There is NO wall-clock read anywhere in this
   module (the parity tests scan the source), and the searcher's own
   host timings are never read: every timestamp is computed, so every
   schedule — arrivals, token grants, batch cuts, departures — is a pure
   function of the trace and the config, equal to the reference's.
2. **Deadline-aware batch cutting.** A batch is cut when the queue holds
   ``max_batch`` granted requests (reason ``"full"``) OR when the oldest
   queued request's slack runs out (reason ``"deadline"``): with the
   engine's :class:`~repro_torch.core.search.engine.ServiceModel` (linear
   in batch size, priced from the T_IO/T_PQ/T_EX/T_DEC I/O model), a batch
   of n containing a request due at D must be cut by ``D - service_us(n)``.
   The final partial batch drains when the trace ends (``"drain"``). Cuts
   wait for the (single, modeled) server: a batch in service blocks the
   next cut until its modeled departure.
3. **Per-tenant token buckets.** Each tenant's admissions are throttled by
   a token bucket (``rate_qps``, ``burst``): a request without a token is
   *deferred* (per-tenant FIFO) until the bucket refills. Conservation —
   grants in any window <= rate * dt + burst — is a pinned property.
4. **Per-tenant cache partitions.** Each configured tenant gets its own
   ``BlockStore`` LRU partition drawing on the searcher's shared budget
   (``ServeConfig(shared_budget=True)``), with ``cache_floor_bytes`` as its
   quota floor.

Admission changes *when* and *with whom* a query is served, never *what*
it returns: every served request's ids/dists equal a solo search on the
same pinned snapshot bit for bit, and each cut batch pins exactly one
snapshot version. The searcher runs on its own device (the card unless it
was built with ``device="cpu"``) and hands each batch's ids and distances
back as host arrays, so serving a batch's rows reads no device.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..core.search.engine import ServiceModel, service_model_from_report
from .ann import plan_buckets

__all__ = ["Request", "TenantConfig", "AdmissionConfig", "TokenBucket",
           "ServedRequest", "BatchRecord", "AdmissionReport",
           "AdmissionQueue", "calibrate_service_model", "poisson_trace",
           "bursty_trace", "latency_percentiles"]


# ---------------------------------------------------------------- requests
@dataclass(frozen=True)
class Request:
    """One open-loop request: who, when, and by when."""
    rid: int                  # unique per trace (ties broken by rid)
    tenant: str
    arrival_us: float         # simulated clock
    deadline_us: float        # absolute simulated deadline
    query: object             # np [d] float32


@dataclass(frozen=True)
class TenantConfig:
    """Per-tenant quotas. Defaults are 'no throttle, no reserved cache'."""
    rate_qps: float = math.inf   # token refill rate (requests/second)
    burst: float = 1.0           # bucket depth (also the initial fill)
    cache_floor_bytes: int = 0   # SharedBudget quota floor for the
                                 # tenant's LRU partition


@dataclass
class AdmissionConfig:
    max_batch: int = 32          # cut when this many granted requests queue
    drain_partial: bool = True   # cut the final partial batch at trace end
    align_buckets: bool = False  # deadline cuts snap to the searcher's
                                 # plan_buckets grid: serve the largest
                                 # zero-padding prefix now and defer the
                                 # ragged tail — IFF every deferred request
                                 # still makes its deadline at the next
                                 # possible cut (slack pays for alignment,
                                 # never the other way around)


# ------------------------------------------------------------ token bucket
class TokenBucket:
    """Deterministic token bucket on the simulated clock.

    Tokens refill continuously at ``rate_qps`` up to ``burst``; the bucket
    starts full. State only mutates on :meth:`try_acquire`;
    :meth:`peek_grant_us` is pure, so the event loop can ask "when could
    the next deferred request be granted" without spending anything.
    ``grant_log_us`` records every grant time — the conservation property
    (grants in any window ≤ rate·Δt + burst) is asserted against it.
    """

    def __init__(self, rate_qps: float = math.inf, burst: float = 1.0):
        if burst < 1.0:
            raise ValueError(f"burst must admit at least one request, "
                             f"got {burst}")
        self.rate_qps = float(rate_qps)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t_us = 0.0
        self.granted = 0
        self.grant_log_us: list = []

    def _refill(self, now_us: float) -> None:
        if math.isinf(self.rate_qps):
            # An unthrottled bucket is always full — even when the clock
            # has not advanced (equal arrival timestamps are legal input),
            # so try_acquire never fails where peek_grant_us says "now".
            self.tokens = self.burst
            self.t_us = max(self.t_us, now_us)
        elif now_us > self.t_us:
            self.tokens = min(
                self.burst,
                self.tokens + self.rate_qps * (now_us - self.t_us) / 1e6)
            self.t_us = now_us

    def try_acquire(self, now_us: float) -> bool:
        """Spend one token at ``now_us`` if available (1e-9 float slop)."""
        self._refill(now_us)
        if self.tokens >= 1.0 - 1e-9:
            self.tokens -= 1.0
            self.granted += 1
            self.grant_log_us.append(now_us)
            return True
        return False

    def peek_grant_us(self, now_us: float) -> float:
        """Earliest simulated time ≥ now at which one token is available
        (inf for a zero-rate bucket that is empty). Pure — no state."""
        if math.isinf(self.rate_qps):
            return now_us
        tokens = self.tokens
        if now_us > self.t_us:
            tokens = min(self.burst,
                         tokens + self.rate_qps * (now_us - self.t_us) / 1e6)
        if tokens >= 1.0 - 1e-9:
            return now_us
        if self.rate_qps <= 0.0:
            return math.inf
        return max(now_us, self.t_us) + (1.0 - tokens) * 1e6 / self.rate_qps


# ---------------------------------------------------------------- results
@dataclass
class ServedRequest:
    rid: int
    tenant: str
    arrival_us: float
    admit_us: float           # token grant (== arrival when not throttled)
    cut_us: float             # batch cut on the simulated clock
    depart_us: float          # cut + modeled batch service
    deadline_us: float
    batch_idx: int
    snapshot_version: int
    ids: object = None        # np [K] global ids — bit-identical to solo
    dists: object = None      # np [K] exact re-ranked distances

    @property
    def latency_us(self) -> float:
        return self.depart_us - self.arrival_us

    @property
    def queue_wait_us(self) -> float:
        return self.cut_us - self.arrival_us

    @property
    def slack_at_depart_us(self) -> float:
        return self.deadline_us - self.depart_us

    @property
    def deadline_met(self) -> bool:
        return self.depart_us <= self.deadline_us


@dataclass
class BatchRecord:
    """One cut batch, for the report and the property tier."""
    idx: int
    cut_us: float
    reason: str               # "full" | "deadline" | "drain"
    n: int
    service_us: float
    depart_us: float
    snapshot_version: int
    was_busy_until_us: float  # server busy horizon when this cut fired
    forced_rid: int = -1      # the request whose slack forced a deadline cut
    aligned_from: int = -1    # pre-alignment queue depth when a deadline
                              # cut was snapped to the bucket grid (-1: no
                              # alignment applied)
    tenants: dict = field(default_factory=dict)
    admit_us_max: float = 0.0  # latest token grant in the batch
    latest_cut_min_us: float = 0.0  # tightest latest-cut bound in the batch
    report: object = None     # the searcher's BatchReport for this cut


@dataclass
class AdmissionReport:
    n_requests: int = 0
    n_batches: int = 0
    makespan_us: float = 0.0      # first arrival -> last departure
    qps: float = 0.0              # served / makespan (modeled, open loop)
    deadline_misses: int = 0
    batches: list = field(default_factory=list)
    tenant_stats: dict = field(default_factory=dict)
    latency: dict = field(default_factory=dict)    # p50/p95/p99/mean µs


def latency_percentiles(served: list, qs=(50, 95, 99)) -> dict:
    """p50/p95/p99 (+mean/max) of arrival->departure modeled latency."""
    if not served:
        return {f"p{q}": 0.0 for q in qs} | dict(mean=0.0, max=0.0)
    lat = np.asarray([s.latency_us for s in served], np.float64)
    out = {f"p{q}": float(np.percentile(lat, q)) for q in qs}
    out["mean"] = float(lat.mean())
    out["max"] = float(lat.max())
    return out


def calibrate_service_model(searcher, probe_queries,
                            base_us: float | None = None) -> ServiceModel:
    """Serve one probe batch (accounted) and derive the linear
    :class:`ServiceModel` from its modeled per-query latency — the
    engine-pricing slack hook. Deterministic for a fixed probe. The probe
    warms the searcher's modeled LRU partitions; callers wanting
    cold-cache accounting should probe on a scratch searcher."""
    _, _, report = searcher.search(np.asarray(probe_queries, np.float32))
    if base_us is None:
        return service_model_from_report(report)
    return service_model_from_report(report, base_us=base_us)


# ----------------------------------------------------------- event loop
@dataclass
class _Pending:
    req: Request
    admit_us: float


class AdmissionQueue:
    """The open-loop admission loop over a ``BatchedSearcher``.

    >>> model = calibrate_service_model(searcher, probe)
    >>> q = AdmissionQueue(searcher, model,
    ...                    tenants={"free": TenantConfig(rate_qps=500)})
    >>> served, report = q.run(poisson_trace(queries, rate_qps=2000, seed=0))

    Event order at equal simulated times is fixed (token grants to deferred
    requests, then new arrivals, then the cut) so runs are reproducible
    byte-for-byte. ``on_batch(record, served_batch)`` fires after each cut
    — tests use it to publish a snapshot *mid-queue* deterministically.
    """

    def __init__(self, searcher, model: ServiceModel,
                 cfg: AdmissionConfig | None = None,
                 tenants: dict | None = None, on_batch=None):
        self.searcher = searcher
        self.model = model
        self.cfg = cfg or AdmissionConfig()
        if self.cfg.max_batch <= 0:
            raise ValueError("max_batch must be positive")
        self.tenant_cfg: dict = dict(tenants or {})
        self.buckets: dict = {}
        self.on_batch = on_batch
        for name, tc in self.tenant_cfg.items():
            self.buckets[name] = TokenBucket(tc.rate_qps, tc.burst)
            if hasattr(searcher, "register_tenant"):
                searcher.register_tenant(name,
                                         floor_bytes=tc.cache_floor_bytes)

    def _bucket(self, tenant: str) -> TokenBucket:
        if tenant not in self.buckets:
            tc = self.tenant_cfg.setdefault(tenant, TenantConfig())
            self.buckets[tenant] = TokenBucket(tc.rate_qps, tc.burst)
        return self.buckets[tenant]

    # ------------------------------------------------------------- policy
    def _cut_time(self, queued: list, busy_until: float, now: float,
                  draining: bool) -> float:
        """Earliest simulated time the current queue should be cut: as
        soon as the server frees for a full queue, at the tightest
        latest-cut bound for a deadline cut, immediately on drain."""
        if not queued:
            return math.inf
        if len(queued) >= self.cfg.max_batch or \
                (draining and self.cfg.drain_partial):
            return max(busy_until, now)
        n = len(queued)
        forced = min(self.model.latest_cut_us(p.req.deadline_us, n)
                     for p in queued)
        if forced <= now:            # already past-due: cut asap
            return max(busy_until, now)
        return max(busy_until, forced)

    # --------------------------------------------------------------- run
    def run(self, requests: list) -> tuple:
        """Drain an open-loop trace; -> (list[ServedRequest] in service
        order, AdmissionReport). Every request is served exactly once —
        token quotas delay admission, they never drop (a zero-rate tenant
        with pending requests raises rather than starving silently)."""
        reqs = sorted(requests, key=lambda r: (r.arrival_us, r.rid))
        if len({r.rid for r in reqs}) != len(reqs):
            raise ValueError("request rids must be unique within a trace")
        now = 0.0
        busy_until = 0.0
        i = 0
        queued: list = []                       # granted, admission order
        deferred: dict = {}                     # tenant -> deque[Request]
        served: list = []
        records: list = []

        def have_deferred():
            return any(dq for dq in deferred.values())

        while i < len(reqs) or queued or have_deferred():
            t_arr = reqs[i].arrival_us if i < len(reqs) else math.inf
            t_tok = math.inf
            for name in sorted(deferred):
                if deferred[name]:
                    t_tok = min(t_tok,
                                self._bucket(name).peek_grant_us(now))
            draining = i >= len(reqs) and not have_deferred()
            t_cut = self._cut_time(queued, busy_until, now, draining)
            t = min(t_arr, t_tok, t_cut)
            if math.isinf(t):
                starved = {n: len(dq) for n, dq in deferred.items() if dq}
                raise RuntimeError(
                    f"admission starved: deferred requests can never be "
                    f"granted (zero-rate tenants?) {starved}")
            now = max(now, t)
            # 1) token grants to deferred requests (they arrived first)
            for name in sorted(deferred):
                dq = deferred[name]
                while dq and self._bucket(name).try_acquire(now):
                    queued.append(_Pending(dq.popleft(), admit_us=now))
            # 2) new arrivals up to the clock
            while i < len(reqs) and reqs[i].arrival_us <= now:
                r = reqs[i]
                i += 1
                dq = deferred.setdefault(r.tenant, deque())
                if not dq and self._bucket(r.tenant).try_acquire(now):
                    queued.append(_Pending(r, admit_us=now))
                else:
                    dq.append(r)     # per-tenant FIFO behind the quota
            # 3) cut, if the clock reached the cut condition
            draining = i >= len(reqs) and not have_deferred()
            cut_at = self._cut_time(queued, busy_until, now, draining)
            if queued and cut_at <= now:
                busy_until = self._cut(queued, now, busy_until, draining,
                                       served, records)
        report = self._report(reqs, served, records)
        return served, report

    def _aligned_prefix(self, n: int) -> int:
        """Largest m ≤ n expressible as a sum of the searcher's dispatch
        buckets (greedy, largest-first) — the prefix that pads to zero on
        the ``plan_buckets`` grid. 0 when the searcher exposes no bucket
        config or nothing fits."""
        cfg = getattr(self.searcher, "cfg", None)
        if cfg is None or not getattr(cfg, "buckets", None):
            return 0
        m, rem = 0, n
        for b in sorted(cfg.buckets, reverse=True):
            m += (rem // b) * b
            rem -= (rem // b) * b
        return m

    def _cut(self, queued: list, now: float, busy_until: float,
             draining: bool, served: list, records: list) -> float:
        n_before = len(queued)
        batch = queued[:self.cfg.max_batch]
        del queued[:len(batch)]
        n = len(batch)
        if n_before >= self.cfg.max_batch:
            reason, forced_rid = "full", -1
        else:
            forced = min(batch,
                         key=lambda p: (self.model.latest_cut_us(
                             p.req.deadline_us, n_before), p.req.rid))
            forced_latest = self.model.latest_cut_us(
                forced.req.deadline_us, n_before)
            if forced_latest <= now:
                reason, forced_rid = "deadline", forced.req.rid
            else:
                reason, forced_rid = "drain", -1
        aligned_from = -1
        if reason == "deadline" and self.cfg.align_buckets:
            # Snap the deadline cut to the dispatch grid: a ragged n pads
            # its last bucket with repeated queries the engine prices but
            # nobody asked for. Serve the largest zero-padding prefix and
            # push the tail back to the queue head — but only when every
            # deferred request can still be cut no later than its own
            # latest-cut bound at the NEXT opportunity (this batch's
            # departure), so alignment spends slack, never deadlines.
            scfg = self.searcher.cfg
            m = self._aligned_prefix(n)
            if 0 < m < n:
                tail = batch[m:]
                depart_if = now + self.model.service_us(m)
                cur_pad = sum(b - c for _, c, b in plan_buckets(
                    n, scfg.buckets, scfg.max_chunks))
                new_pad = sum(b - c for _, c, b in plan_buckets(
                    m, scfg.buckets, scfg.max_chunks))
                if cur_pad > 0 and new_pad == 0 and all(
                        self.model.latest_cut_us(p.req.deadline_us,
                                                 len(tail)) >= depart_if
                        for p in tail):
                    queued[0:0] = tail      # head of queue, order kept
                    batch = batch[:m]
                    n = m
                    aligned_from = n_before
        queries = np.stack([np.asarray(p.req.query, np.float32)
                            for p in batch])
        tenants = [p.req.tenant for p in batch]
        ids, dists, rep = self.searcher.search(queries, tenants=tenants)
        ids, dists = np.asarray(ids), np.asarray(dists)   # host arrays
        service = self.model.service_us(n)
        depart = now + service
        rec = BatchRecord(
            idx=len(records), cut_us=now, reason=reason, n=n,
            service_us=service, depart_us=depart,
            snapshot_version=rep.snapshot_version,
            was_busy_until_us=busy_until, forced_rid=forced_rid,
            aligned_from=aligned_from, tenants=dict(rep.tenants),
            admit_us_max=max(p.admit_us for p in batch),
            latest_cut_min_us=min(
                self.model.latest_cut_us(p.req.deadline_us, n)
                for p in batch))
        # Queue/tenant fields on the searcher's own report (BatchReport).
        waits = [now - p.req.arrival_us for p in batch]
        rep.cut_us = now
        rep.cut_reason = reason
        rep.queue_wait_us_mean = float(np.mean(waits))
        rep.queue_wait_us_max = float(np.max(waits))
        rep.slack_min_us = float(min(p.req.deadline_us - depart
                                     for p in batch))
        rec.report = rep
        records.append(rec)
        out = []
        for row, p in enumerate(batch):
            out.append(ServedRequest(
                rid=p.req.rid, tenant=p.req.tenant,
                arrival_us=p.req.arrival_us, admit_us=p.admit_us,
                cut_us=now, depart_us=depart,
                deadline_us=p.req.deadline_us, batch_idx=rec.idx,
                snapshot_version=rep.snapshot_version,
                ids=ids[row], dists=dists[row]))
        served.extend(out)
        if self.on_batch is not None:
            self.on_batch(rec, out)
        return depart

    def _report(self, reqs: list, served: list,
                records: list) -> AdmissionReport:
        report = AdmissionReport(
            n_requests=len(reqs), n_batches=len(records), batches=records)
        if served:
            t0 = min(s.arrival_us for s in served)
            t1 = max(s.depart_us for s in served)
            report.makespan_us = t1 - t0
            report.qps = len(served) / max(report.makespan_us, 1e-9) * 1e6
            report.deadline_misses = sum(not s.deadline_met for s in served)
            report.latency = latency_percentiles(served)
        for name, bucket in sorted(self.buckets.items()):
            rows = [s for s in served if s.tenant == name]
            report.tenant_stats[name] = dict(
                granted=bucket.granted,
                served=len(rows),
                deadline_misses=sum(not s.deadline_met for s in rows),
                queue_wait_us_mean=float(np.mean(
                    [s.queue_wait_us for s in rows])) if rows else 0.0,
                throttle_us_mean=float(np.mean(
                    [s.admit_us - s.arrival_us for s in rows]))
                if rows else 0.0)
        return report


# ----------------------------------------------------------------- traces
def _assemble(queries, arrivals, tenants, deadline_us, rng,
              deadline_jitter_us) -> list:
    reqs = []
    for rid, (arr, tenant) in enumerate(zip(arrivals, tenants)):
        slack = deadline_us
        if deadline_jitter_us > 0:
            slack = slack + float(rng.uniform(0.0, deadline_jitter_us))
        reqs.append(Request(rid=rid, tenant=str(tenant),
                            arrival_us=float(arr),
                            deadline_us=float(arr) + slack,
                            query=np.asarray(queries[rid % len(queries)],
                                             np.float32)))
    return reqs


def _pick_tenants(rng, n, tenants, weights):
    names = list(tenants)
    if weights is None:
        w = np.full(len(names), 1.0 / len(names))
    else:
        w = np.asarray(weights, np.float64)
        w = w / w.sum()
    return rng.choice(names, size=n, p=w)


def poisson_trace(queries, rate_qps: float, n: int | None = None,
                  tenants=("t0",), weights=None, deadline_us: float = 5e3,
                  deadline_jitter_us: float = 0.0, seed: int = 0,
                  start_us: float = 0.0) -> list:
    """Open-loop Poisson arrivals at ``rate_qps`` (exponential gaps),
    tenants drawn by weight, deadline = arrival + ``deadline_us`` (+ U[0,
    jitter]). Deterministic for a seed — the simulated-clock contract."""
    n = len(queries) if n is None else n
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1e6 / rate_qps, size=n)
    arrivals = start_us + np.cumsum(gaps)
    who = _pick_tenants(rng, n, tenants, weights)
    return _assemble(queries, arrivals, who, deadline_us, rng,
                     deadline_jitter_us)


def bursty_trace(queries, rate_qps: float, n: int | None = None,
                 burst_factor: float = 8.0, duty: float = 0.2,
                 period_us: float = 20e3, tenants=("t0",), weights=None,
                 deadline_us: float = 5e3, deadline_jitter_us: float = 0.0,
                 seed: int = 0, start_us: float = 0.0) -> list:
    """On/off (Markov-modulated-style) arrivals with the SAME mean rate as
    :func:`poisson_trace`: a fraction ``duty`` of each ``period_us`` is an
    ON phase running at ``burst_factor``× the base ON-share rate, the rest
    is a quiet phase carrying the remainder. ``burst_factor`` ≥ 1
    concentrates the same offered load into spikes — the tail-latency
    stressor the bench's regression gate compares against Poisson."""
    n = len(queries) if n is None else n
    if not 0.0 < duty < 1.0:
        raise ValueError(f"duty must be in (0, 1), got {duty}")
    rng = np.random.default_rng(seed)
    # Split the offered load: ON phases carry min(1, duty*burst_factor) of
    # it compressed into `duty` of the time; OFF phases carry the rest.
    on_share = min(1.0, duty * burst_factor)
    on_rate = rate_qps * on_share / duty
    off_rate = rate_qps * (1.0 - on_share) / (1.0 - duty)
    arrivals = []
    t = start_us
    while len(arrivals) < n:
        phase_on = ((t - start_us) % period_us) < duty * period_us
        rate = on_rate if phase_on else off_rate
        if rate <= 0.0:       # jump to the next phase boundary
            k = (t - start_us) // period_us
            t = start_us + ((k + duty) if phase_on else (k + 1.0)) * period_us
            continue
        gap = float(rng.exponential(1e6 / rate))
        # A gap crossing the phase boundary re-draws from the boundary —
        # keeps each phase's arrival process at its own rate.
        phase_end = start_us + (
            ((t - start_us) // period_us)
            + (duty if phase_on else 1.0)) * period_us
        if t + gap > phase_end:
            t = phase_end
            continue
        t += gap
        arrivals.append(t)
    who = _pick_tenants(rng, n, tenants, weights)
    return _assemble(queries, np.asarray(arrivals), who, deadline_us, rng,
                     deadline_jitter_us)
