"""Port parity tier for the SLO-aware admission queue
(``repro_torch.serve.admission``) over the port's ``BatchedSearcher`` on
the CPU.

- Every case of tests/test_admission.py on the port: token-bucket
  conservation, deadline monotonicity, batch invisibility (every served
  row equal to a solo search bit for bit), deterministic replay, cut
  policies, tenant partitions, aligned deadline cuts, guard rails. The
  property cases take the reference file's seeded fallback draws.
- Schedule parity: the reference's queue and the port's on the
  reference's world (n=300, dim 16) and the same seeded Poisson, bursty and
  alignment traces: cut times, reasons, sizes, admit and depart µs equal
  within rtol 1e-12, the batch reports equal (``assert_same_report``,
  the admission fields included), served ids identical, distances within
  rtol 1e-6.
- The two hot-swap cases of tests/test_snapshot.py through the queue, on
  both packages.
"""
import inspect
import math
import threading
import zlib

import numpy as np
import pytest

from repro.core.index import build_device_index
from repro.core.search import beam as jbeam
from repro.data.synthetic import make_queries, make_vector_dataset
from repro.serve import admission as jadm
from repro.serve import ann as jann

import repro_torch.serve.admission as admission_mod
from repro_torch.core.index import device_index_from_numpy
from repro_torch.core.search import beam as tbeam
from repro_torch.core.search.engine import (ServiceModel,
                                            service_model_from_report)
from repro_torch.core.update import consistency as tcons
from repro_torch.serve import ann
from repro_torch.serve.admission import (AdmissionConfig, AdmissionQueue,
                                         Request, TenantConfig, TokenBucket,
                                         bursty_trace,
                                         calibrate_service_model,
                                         latency_percentiles, poisson_trace)

from torch_parity import assert_same_report, streaming_pair


def hypothesize(n_fallback=8, **bounds):
    """The reference file's deterministic seeded-numpy draws of the same
    bounds (tests/test_admission.py's fallback), as a parametrization."""
    def deco(fn):
        rng = np.random.default_rng(zlib.crc32(fn.__name__.encode()))
        cases = [tuple(int(rng.integers(lo, hi + 1))
                       for lo, hi in bounds.values())
                 for _ in range(n_fallback)]
        if len(bounds) == 1:
            cases = [c[0] for c in cases]
        return pytest.mark.parametrize(",".join(bounds), cases)(fn)
    return deco


# ---------------------------------------------------------------- fixtures
N, DIM, R = 300, 16, 12


@pytest.fixture(scope="module")
def world():
    """(reference index, port index on the CPU, queries): the reference's
    world, handed to the port as numpy."""
    vecs = make_vector_dataset("prop-like", n=N, dim=DIM,
                               seed=0).astype(np.float32)
    jindex, _, _ = build_device_index(vecs, r=R, l_build=24, pq_m=4, seed=0)
    tindex = device_index_from_numpy(
        {k: np.asarray(v) for k, v in jindex._asdict().items()}, "cpu")
    queries = make_queries("prop-like", 48, DIM).astype(np.float32)
    return jindex, tindex, queries


def _p(mod):
    return mod.SearchParams(l_size=24, beam_width=4, k=5, rerank_batch=5,
                            r_max=R, universe=N, max_iters=48)


def _searcher(world, buckets=(1, 8), **cfg_kw):
    return ann.BatchedSearcher(world[1], _p(tbeam),
                               ann.ServeConfig(buckets=buckets, **cfg_kw),
                               device="cpu")


def _ref_searcher(world, buckets=(1, 8), **cfg_kw):
    return jann.BatchedSearcher(world[0], _p(jbeam),
                                jann.ServeConfig(buckets=buckets, **cfg_kw))


@pytest.fixture(scope="module")
def model(world):
    """The port's calibration, equal to the reference's (rtol 1e-12)."""
    _, _, queries = world
    m = calibrate_service_model(_searcher(world, buckets=(8,)), queries[:8])
    want = jadm.calibrate_service_model(_ref_searcher(world, buckets=(8,)),
                                        queries[:8])
    assert m.per_query_us == pytest.approx(want.per_query_us, rel=1e-12)
    assert m.base_us == want.base_us
    return m


@pytest.fixture(scope="module")
def solo(world):
    """One request per call through the same device path, cached per
    query row."""
    searcher = _searcher(world, buckets=(1,))
    queries = world[2]
    cache = {}

    def rows(query):
        key = next(i for i in range(len(queries))
                   if np.array_equal(queries[i], query))
        if key not in cache:
            ids, d, _ = searcher.search(np.asarray(query)[None])
            cache[key] = (ids[0], d[0])
        return cache[key]
    return rows


# ------------------------------------------------- simulated-clock contract
def test_no_wall_clock_in_admission():
    """The port's admission.py never reads the wall clock."""
    src = inspect.getsource(admission_mod)
    for needle in ("import time", "perf_counter", "monotonic(",
                   "time.time", "datetime", "wall_s"):
        assert needle not in src, f"wall-clock read in admission.py: {needle}"


# --------------------------------------------------------- token buckets
@hypothesize(rate=(1, 5000), burst=(1, 12), seed=(0, 2**31))
def test_token_bucket_conservation(rate, burst, seed):
    """granted(t1, t2] <= rate * (t2 - t1) + burst for EVERY window; the
    grant log equals the reference bucket's on the same schedule."""
    rng = np.random.default_rng(seed)
    b = TokenBucket(rate_qps=float(rate), burst=float(burst))
    jb = jadm.TokenBucket(rate_qps=float(rate), burst=float(burst))
    t = 0.0
    for _ in range(200):
        t += float(rng.exponential(2e4 / rate))
        assert b.try_acquire(t) == jb.try_acquire(t)
    log = np.asarray(b.grant_log_us)
    assert b.grant_log_us == jb.grant_log_us
    assert len(log) == b.granted
    for j in range(len(log)):
        assert j + 1 <= rate * log[j] / 1e6 + burst + 1e-3
    n_window = np.arange(len(log))[None, :] - np.arange(len(log))[:, None]
    dt_us = log[None, :] - log[:, None]
    upper = np.triu(np.ones_like(n_window, dtype=bool), 1)
    assert (n_window[upper] <= rate * dt_us[upper] / 1e6 + burst
            + 1e-3).all()


@hypothesize(rate=(1, 2000), burst=(1, 6), seed=(0, 2**31))
def test_token_bucket_peek_matches_acquire(rate, burst, seed):
    rng = np.random.default_rng(seed)
    b = TokenBucket(rate_qps=float(rate), burst=float(burst))
    t = 0.0
    for _ in range(40):
        t += float(rng.exponential(1e4))
        grant_at = b.peek_grant_us(t)
        if grant_at > t + 1.0:
            assert not b.try_acquire(t)
            assert not b.try_acquire(grant_at - 1.0)
            t = grant_at
        assert b.try_acquire(t if grant_at <= t else grant_at)


def test_token_bucket_validates_burst():
    with pytest.raises(ValueError):
        TokenBucket(rate_qps=10.0, burst=0.5)


def test_unlimited_bucket_always_grants():
    b = TokenBucket()
    assert all(b.try_acquire(float(t)) for t in range(50))
    assert all(b.try_acquire(50.0) for _ in range(10))
    assert b.peek_grant_us(50.0) == 50.0


# ----------------------------------------------------------- service model
def test_service_model_slack_formula():
    m = ServiceModel(per_query_us=100.0, base_us=80.0)
    assert m.service_us(4) == 80.0 + 400.0
    assert m.latest_cut_us(10_000.0, 4) == 10_000.0 - 480.0
    assert m.slack_us(10_000.0, 9_000.0, 4) == 10_000.0 - 480.0 - 9_000.0
    cuts = [m.latest_cut_us(10_000.0, n) for n in range(1, 8)]
    assert cuts == sorted(cuts, reverse=True)
    assert m.latest_cut_us(10_000.0, 0) == m.latest_cut_us(10_000.0, 1)


def test_service_model_from_report_requires_accounting():
    class R:
        modeled_latency_us = 0.0
    with pytest.raises(ValueError):
        service_model_from_report(R())

    class R2:
        modeled_latency_us = 123.0
    assert service_model_from_report(R2()).per_query_us == 123.0


# ------------------------------------------------------ deadline monotone
def _run(world, model, *, seed, rate=1500, n=40, max_batch=8,
         deadline_us=20_000.0, tenants=None, buckets=(1, 8), **trace_kw):
    searcher = _searcher(world, buckets=buckets, shared_budget=True)
    trace = poisson_trace(world[2], rate_qps=rate, n=n,
                          tenants=tuple((tenants or {"t0": TenantConfig()})),
                          deadline_us=deadline_us, seed=seed, **trace_kw)
    q = AdmissionQueue(searcher, model, AdmissionConfig(max_batch=max_batch),
                       tenants=tenants)
    served, report = q.run(trace)
    return searcher, trace, served, report


@hypothesize(seed=(0, 2**31))
def test_deadline_monotonicity(world, model, seed):
    """Every request served once; no cut later than its condition held
    with the server free; the server is never preempted."""
    _, trace, served, report = _run(world, model, seed=seed)
    assert sorted(s.rid for s in served) == sorted(r.rid for r in trace)
    prev_depart = 0.0
    for rec in report.batches:
        assert rec.cut_us >= rec.was_busy_until_us - 1e-6
        assert rec.cut_us <= max(rec.was_busy_until_us, rec.admit_us_max,
                                 rec.latest_cut_min_us) + 1e-6, \
            (rec.idx, rec.reason)
        assert rec.depart_us == pytest.approx(rec.cut_us + rec.service_us)
        assert rec.depart_us >= prev_depart - 1e-6
        prev_depart = rec.depart_us
        if rec.reason == "deadline":
            rids = {s.rid for s in served if s.batch_idx == rec.idx}
            assert rec.forced_rid in rids


@hypothesize(seed=(0, 2**31))
def test_conservation_under_throttle(world, model, seed):
    tenants = {"hot": TenantConfig(rate_qps=800, burst=3),
               "cold": TenantConfig()}
    searcher, trace, served, report = _run(
        world, model, seed=seed, n=30, tenants=tenants,
        deadline_us=50_000.0)
    assert len(served) == len(trace)
    hot = [s for s in served if s.tenant == "hot"]
    if hot:
        assert report.tenant_stats["hot"]["granted"] == len(hot)
        assert all(s.admit_us >= s.arrival_us - 1e-6 for s in served)


# ------------------------------------------------------- batch invisibility
@pytest.mark.parametrize("max_batch", [1, 7, 32])
def test_batch_invisibility(world, model, solo, max_batch):
    """Every admission-served row equals a solo call bit for bit."""
    searcher = _searcher(world, buckets=(1, 8, 32), shared_budget=True)
    trace = poisson_trace(world[2], rate_qps=2500, n=36,
                          tenants=("a", "b"), weights=(0.7, 0.3),
                          deadline_us=30_000.0, seed=7)
    q = AdmissionQueue(searcher, model, AdmissionConfig(max_batch=max_batch))
    served, report = q.run(trace)
    assert len(served) == len(trace)
    if max_batch > 1:
        assert any(rec.n > 1 for rec in report.batches)
    if max_batch == 7:
        assert any(rec.n == 7 for rec in report.batches)
    by_rid = {r.rid: r for r in trace}
    for s in served:
        i1, d1 = solo(by_rid[s.rid].query)
        np.testing.assert_array_equal(s.ids, i1)
        np.testing.assert_array_equal(s.dists, d1)


def test_deterministic_replay(world, model):
    runs = []
    for _ in range(2):
        _, _, served, report = _run(world, model, seed=3,
                                    tenants={"hot": TenantConfig(
                                        rate_qps=900, burst=2)})
        runs.append((served, report))
    a, b = runs
    assert [(s.rid, s.admit_us, s.cut_us, s.depart_us) for s in a[0]] == \
           [(s.rid, s.admit_us, s.cut_us, s.depart_us) for s in b[0]]
    assert [(r.cut_us, r.reason, r.n) for r in a[1].batches] == \
           [(r.cut_us, r.reason, r.n) for r in b[1].batches]
    for sa, sb in zip(a[0], b[0]):
        np.testing.assert_array_equal(sa.ids, sb.ids)


@hypothesize(seed=(0, 2**31), dup=(2, 5))
def test_equal_arrival_timestamps(world, model, seed, dup):
    queries = world[2]
    rng = np.random.default_rng(seed)
    t_shared = float(rng.uniform(0.0, 5e3))
    trace = [Request(rid=r, tenant="t0", arrival_us=t_shared,
                     deadline_us=t_shared + 50_000.0,
                     query=queries[r % len(queries)])
             for r in range(dup)]
    trace += [Request(rid=dup + r, tenant="slow", arrival_us=t_shared,
                      deadline_us=t_shared + 200_000.0,
                      query=queries[r % len(queries)])
              for r in range(2)]
    searcher = _searcher(world, buckets=(1, 8), shared_budget=True)
    q = AdmissionQueue(searcher, model, AdmissionConfig(max_batch=8),
                       tenants={"slow": TenantConfig(rate_qps=400,
                                                     burst=1)})
    served, report = q.run(trace)
    assert sorted(s.rid for s in served) == list(range(dup + 2))
    same_instant = [s for s in served if s.tenant == "t0"]
    assert all(s.admit_us == t_shared for s in same_instant)
    assert [s.rid for s in same_instant] == sorted(
        s.rid for s in same_instant)


# ----------------------------------------------------- cut-policy shapes
def test_full_cuts_under_pressure(world, model):
    queries = world[2]
    _, _, served, report = _run(world, model, seed=11, rate=5000,
                                n=40, max_batch=8, deadline_us=60_000.0)
    reasons = [r.reason for r in report.batches]
    assert "full" in reasons
    assert reasons[-1] in ("drain", "deadline", "full")
    t1 = poisson_trace(queries, rate_qps=1000, n=20, seed=5)
    t2 = poisson_trace(queries, rate_qps=1000, n=20, seed=5)
    assert [(r.arrival_us, r.tenant, r.deadline_us) for r in t1] == \
           [(r.arrival_us, r.tenant, r.deadline_us) for r in t2]
    b1 = bursty_trace(queries, rate_qps=1000, n=20, seed=5)
    b2 = bursty_trace(queries, rate_qps=1000, n=20, seed=5)
    assert [r.arrival_us for r in b1] == [r.arrival_us for r in b2]


def test_tight_deadlines_force_early_cuts(world, model):
    _, _, served, report = _run(world, model, seed=2, rate=600,
                                n=24, max_batch=16,
                                deadline_us=model.service_us(4) + 2_000.0)
    assert any(r.reason == "deadline" for r in report.batches)
    assert all(r.n < 16 for r in report.batches)


def test_bursty_tail_worse_than_poisson(world, model):
    kw = dict(rate_qps=1200, n=48, deadline_us=25_000.0, seed=4)
    lat = {}
    for name, maker in (("poisson", poisson_trace),
                        ("bursty", lambda q, **k: bursty_trace(
                            q, burst_factor=10.0, **k))):
        searcher = _searcher(world, buckets=(1, 8), shared_budget=True)
        q = AdmissionQueue(searcher, model, AdmissionConfig(max_batch=8))
        served, report = q.run(maker(world[2], **kw))
        lat[name] = report.latency["p99"]
    assert lat["bursty"] >= lat["poisson"] * 0.8


# -------------------------------------------------- tenant cache isolation
def test_tenant_partitions_registered_and_accounted(world, model):
    tenants = {"hot": TenantConfig(rate_qps=1200, burst=4,
                                   cache_floor_bytes=2048),
               "cold": TenantConfig(cache_floor_bytes=2048)}
    searcher, trace, served, report = _run(
        world, model, seed=9, n=32, tenants=tenants,
        deadline_us=40_000.0, weights=(0.8, 0.2))
    stats = searcher.blocks.cache_stats()
    assert {"tenant:hot", "tenant:cold"} <= set(stats["partitions"])
    assert stats["hits"] + stats["misses"] == sum(
        p["hits"] + p["misses"] for p in stats["partitions"].values())
    assert stats["memory_bytes"] <= searcher.cfg.cache_bytes
    comp = searcher.blocks.stats()["components"]
    assert any(k.startswith("tenant:") and v["reads"] > 0
               for k, v in comp.items())
    for rec in report.batches:
        assert sum(rec.tenants.values()) == rec.n
        assert rec.report.cut_reason == rec.reason
        assert rec.report.cut_us == rec.cut_us
        assert rec.report.queue_wait_us_mean >= 0.0


def test_tenancy_never_changes_results(world):
    plain = _searcher(world, buckets=(8,))
    labelled = _searcher(world, buckets=(8,), shared_budget=True)
    q = world[2][:8]
    ids_a, d_a, _ = plain.search(q)
    ids_b, d_b, rep = labelled.search(q, tenants=["x", "y"] * 4)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(d_a, d_b)
    assert rep.tenants == {"x": 4, "y": 4}
    assert len(rep.per_query_latency_us) == 8
    with pytest.raises(ValueError):
        labelled.search(q, tenants=["x"])


# ------------------------------------------------------------- guard rails
def test_starvation_raises(world, model):
    queries = world[2]
    trace = [Request(rid=0, tenant="stuck", arrival_us=10.0,
                     deadline_us=1e6, query=queries[0]),
             Request(rid=1, tenant="stuck", arrival_us=20.0,
                     deadline_us=1e6, query=queries[1])]
    q = AdmissionQueue(_searcher(world), model, AdmissionConfig(max_batch=4),
                       tenants={"stuck": TenantConfig(rate_qps=0.0,
                                                      burst=1.0)})
    with pytest.raises(RuntimeError, match="starved"):
        q.run(trace)


def test_duplicate_rid_rejected(world, model):
    r = Request(rid=0, tenant="t", arrival_us=0.0, deadline_us=1e6,
                query=world[2][0])
    with pytest.raises(ValueError, match="unique"):
        AdmissionQueue(_searcher(world), model).run([r, r])


def test_bad_config_rejected(world, model):
    with pytest.raises(ValueError, match="max_batch"):
        AdmissionQueue(_searcher(world), model,
                       AdmissionConfig(max_batch=0))


def test_latency_percentiles_empty():
    out = latency_percentiles([])
    assert out == dict(p50=0.0, p95=0.0, p99=0.0, mean=0.0, max=0.0)


def test_bursty_trace_validates_duty(world):
    with pytest.raises(ValueError, match="duty"):
        bursty_trace(world[2], rate_qps=100, n=4, duty=1.5)


# ------------------------------------------- bucket-grid-aligned deadline cuts
def _alignment_trace(mod, queries, model, n_head=9, n_tail=7):
    """tests/test_admission.py's trace: n_head near-simultaneous arrivals,
    the first one tight enough to force a deadline cut, then n_tail late
    stragglers."""
    tight = model.service_us(n_head) + 100.0
    reqs = [mod.Request(rid=i, tenant="t0", arrival_us=float(i) * 0.1,
                        deadline_us=tight if i == 0 else 1e9,
                        query=queries[i]) for i in range(n_head)]
    late = 10.0 * model.service_us(n_head)
    reqs += [mod.Request(rid=i, tenant="t0", arrival_us=late + i,
                         deadline_us=1e9, query=queries[i])
             for i in range(n_head, n_head + n_tail)]
    return reqs


def test_aligned_deadline_cut_eliminates_padding(world, model):
    def run(align):
        q = AdmissionQueue(_searcher(world, buckets=(8, 32)), model,
                           AdmissionConfig(max_batch=32,
                                           align_buckets=align))
        return q.run(_alignment_trace(admission_mod, world[2], model))

    served0, rep0 = run(False)
    served1, rep1 = run(True)
    pad0 = sum(r.report.n_padded for r in rep0.batches)
    pad1 = sum(r.report.n_padded for r in rep1.batches)
    assert pad0 > 0
    assert pad1 == 0
    assert any(r.aligned_from > r.n for r in rep1.batches)
    assert rep1.deadline_misses <= rep0.deadline_misses
    by0 = {s.rid: s for s in served0}
    by1 = {s.rid: s for s in served1}
    assert set(by0) == set(by1) and len(served1) == len(by1)
    for rid in by0:
        np.testing.assert_array_equal(by0[rid].ids, by1[rid].ids)
        np.testing.assert_array_equal(by0[rid].dists, by1[rid].dists)


def test_alignment_never_sacrifices_a_deadline(world, model):
    queries = world[2]
    q = AdmissionQueue(_searcher(world, buckets=(8, 32)), model,
                       AdmissionConfig(max_batch=32, align_buckets=True))
    tight = model.service_us(9) + 100.0
    reqs = [Request(rid=i, tenant="t0", arrival_us=float(i) * 0.1,
                    deadline_us=tight if i in (0, 8) else 1e9,
                    query=queries[i]) for i in range(9)]
    served, rep = q.run(reqs)
    assert [r.aligned_from for r in rep.batches] == [-1] * len(rep.batches)
    assert rep.deadline_misses == 0
    assert len(served) == 9


# ------------------------------------------- schedule parity with reference
BATCH_FIELDS = ("idx", "cut_us", "reason", "n", "service_us", "depart_us",
                "snapshot_version", "was_busy_until_us", "forced_rid",
                "aligned_from", "tenants", "admit_us_max",
                "latest_cut_min_us")
SERVED_FIELDS = ("rid", "tenant", "arrival_us", "admit_us", "cut_us",
                 "depart_us", "deadline_us", "batch_idx", "snapshot_version")


def _same(a, b, what):
    if isinstance(a, float):
        assert b == pytest.approx(a, rel=1e-12, abs=1e-9), what
    else:
        assert a == b, what


def assert_same_run(want, got):
    """The reference's (served, report) against the port's."""
    (jserved, jrep), (served, rep) = want, got
    assert len(jrep.batches) == len(rep.batches)
    for a, b in zip(jrep.batches, rep.batches):
        for f in BATCH_FIELDS:
            _same(getattr(a, f), getattr(b, f), f"batch {a.idx}: {f}")
        assert_same_report(a.report, b.report)
    assert len(jserved) == len(served)
    for a, b in zip(jserved, served):
        for f in SERVED_FIELDS:
            _same(getattr(a, f), getattr(b, f), f"rid {a.rid}: {f}")
        np.testing.assert_array_equal(b.ids, np.asarray(a.ids))
        np.testing.assert_allclose(b.dists, np.asarray(a.dists), rtol=1e-6)
    for f in ("n_requests", "n_batches", "makespan_us", "qps",
              "deadline_misses"):
        _same(getattr(jrep, f), getattr(rep, f), f)
    assert set(jrep.latency) == set(rep.latency)
    for k, v in jrep.latency.items():
        _same(v, rep.latency[k], f"latency {k}")
    assert jrep.tenant_stats.keys() == rep.tenant_stats.keys()
    for name, stats in jrep.tenant_stats.items():
        for k, v in stats.items():
            _same(v, rep.tenant_stats[name][k], f"{name}: {k}")


def _traces(mod, queries, model):
    kw = dict(n=40, tenants=("hot", "warm", "cold"), weights=(0.6, 0.3, 0.1),
              deadline_us=8_000.0, deadline_jitter_us=12_000.0, seed=21)
    return {
        "poisson": lambda: mod.poisson_trace(queries, rate_qps=1500, **kw),
        "bursty": lambda: mod.bursty_trace(queries, rate_qps=1500,
                                           burst_factor=4.0,
                                           period_us=8_000.0, **kw),
        "aligned": lambda: _alignment_trace(mod, queries, model)}


@pytest.mark.parametrize("trace,buckets,max_batch", [
    ("poisson", (1, 8), 8), ("bursty", (1, 8), 8), ("aligned", (8, 32), 32)])
def test_schedule_matches_reference(world, model, trace, buckets, max_batch):
    """The reference's queue and the port's on one trace, three tenants,
    a token bucket on the hottest, aligned deadline cuts: the same
    schedule (deadline, full and drain cuts, deferred grants, an aligned
    cut), reports and rows."""
    queries = world[2]
    tenants = {"hot": TenantConfig(rate_qps=700, burst=3,
                                   cache_floor_bytes=2048),
               "warm": TenantConfig(cache_floor_bytes=1024)}
    jtenants = {k: jadm.TenantConfig(**vars(v)) for k, v in tenants.items()}
    cfg = dict(max_batch=max_batch, align_buckets=True)
    jmodel = jadm.ServiceModel(model.per_query_us, model.base_us)
    want_trace = _traces(jadm, queries, jmodel)[trace]()
    got_trace = _traces(admission_mod, queries, model)[trace]()
    assert [(r.rid, r.tenant, r.arrival_us, r.deadline_us)
            for r in want_trace] == [(r.rid, r.tenant, r.arrival_us,
                                      r.deadline_us) for r in got_trace]
    want = jadm.AdmissionQueue(
        _ref_searcher(world, buckets=buckets, shared_budget=True), jmodel,
        jadm.AdmissionConfig(**cfg), tenants=jtenants).run(want_trace)
    got = AdmissionQueue(
        _searcher(world, buckets=buckets, shared_budget=True), model,
        AdmissionConfig(**cfg), tenants=tenants).run(got_trace)
    assert_same_run(want, got)
    served, report = got
    reasons = [r.reason for r in report.batches]
    if trace == "aligned":
        assert any(r.aligned_from > r.n for r in report.batches)
    else:
        assert "deadline" in reasons and reasons[-1] == "drain", reasons
        assert any(s.admit_us > s.arrival_us for s in served)
    if trace == "bursty":
        assert "full" in reasons


# ------------------------------------- hot swap under queued load (§3.5)
LIVE_P = dict(l_size=32, k=5, rerank_batch=5, max_iters=64,
              benefit_threshold=0.0)


def _live(seed):
    vecs = make_vector_dataset("prop-like", n=250, dim=16,
                               seed=seed).astype(np.float32)
    return (vecs,) + streaming_pair(vecs, r=12, m=4)


def _live_searcher(pkg, idx, buckets=(1, 4)):
    if pkg == "reference":
        return jann.BatchedSearcher(idx.handle, jbeam.SearchParams(**LIVE_P),
                                    jann.ServeConfig(buckets=buckets))
    return ann.BatchedSearcher(idx.handle, tbeam.SearchParams(**LIVE_P),
                               ann.ServeConfig(buckets=buckets),
                               device="cpu")


def _live_queue(pkg, idx, on_batch):
    mod = jadm if pkg == "reference" else admission_mod
    return mod.AdmissionQueue(_live_searcher(pkg, idx),
                              mod.ServiceModel(per_query_us=150.0,
                                               base_us=80.0),
                              mod.AdmissionConfig(max_batch=4),
                              on_batch=on_batch)


def test_publish_mid_queue_single_version_per_batch():
    """The on_batch hook publishes a merge between cuts 1 and 2, on each
    package: versions monotone with one swap, no batch split, the port's
    schedule and rows equal the reference's, and every served row equals
    a solo search on the archived snapshot of its pinned version."""
    vecs, ref, port = _live(3)
    runs, archived = {}, {0: port.handle.current()}
    for pkg, idx in (("reference", ref), ("port", port)):
        def publish_between_cuts(rec, batch, idx=idx):
            if rec.idx == 1:
                idx.insert(np.array([len(vecs) + rec.idx]),
                           (vecs[0] * 1.0001)[None])
                idx.merge()
        trace = poisson_trace(vecs[:16] + 0.001, rate_qps=4000, n=16,
                              deadline_us=50_000.0, seed=1)
        runs[pkg] = _live_queue(pkg, idx, publish_between_cuts).run(trace)
    archived[1] = port.handle.current()
    assert_same_run(runs["reference"], runs["port"])
    served, report = runs["port"]
    assert len(served) == 16
    versions = [rec.snapshot_version for rec in report.batches]
    assert versions == sorted(versions) and len(set(versions)) == 2
    for s in served:
        assert s.snapshot_version == \
            report.batches[s.batch_idx].snapshot_version
    queries = {r.rid: r.query for r in trace}
    solos = {}
    for s in served:
        if s.snapshot_version not in solos:
            solos[s.snapshot_version] = ann.BatchedSearcher(
                tcons.SnapshotHandle(archived[s.snapshot_version]),
                tbeam.SearchParams(**LIVE_P), ann.ServeConfig(buckets=(1,)),
                device="cpu")
        i1, d1, _ = solos[s.snapshot_version].search(
            np.asarray(queries[s.rid])[None])
        np.testing.assert_array_equal(s.ids, i1[0])
        np.testing.assert_array_equal(s.dists, d1[0])


def test_threaded_publisher_never_splits_a_batch():
    """A publisher THREAD merges while each package's queue drains (the
    handshake lands a publish after cuts 0 and 2): every batch pins one
    version, both publishes land, all requests are served, and the port's
    schedule and rows equal the reference's."""
    vecs, ref, port = _live(5)
    runs = {}
    for pkg, idx in (("reference", ref), ("port", port)):
        publish_now, published, done = (threading.Event(),
                                        threading.Event(), threading.Event())
        failures = []

        def publisher(idx=idx):
            k = 0
            while publish_now.wait(timeout=30.0):
                publish_now.clear()
                if done.is_set():
                    return
                try:
                    nid = len(vecs) + 50 + k
                    k += 1
                    idx.insert(np.array([nid]), (vecs[k] * 1.0003)[None])
                    idx.merge()
                except Exception as e:       # surfaced in the main thread
                    failures.append(e)
                published.set()

        def on_batch(rec, batch):
            if rec.idx in (0, 2):
                published.clear()
                publish_now.set()
                assert published.wait(timeout=30.0), "publisher stalled"

        t = threading.Thread(target=publisher)
        t.start()
        try:
            trace = poisson_trace(vecs[:16] + 0.001, rate_qps=4000, n=16,
                                  deadline_us=50_000.0, seed=2)
            runs[pkg] = _live_queue(pkg, idx, on_batch).run(trace)
        finally:
            done.set()
            publish_now.set()
            t.join(timeout=30.0)
        assert not t.is_alive()
        assert not failures, failures
    assert_same_run(runs["reference"], runs["port"])
    served, report = runs["port"]
    assert len(served) == 16
    versions = [rec.snapshot_version for rec in report.batches]
    assert versions == sorted(versions) and len(set(versions)) == 3
    for s in served:
        assert s.snapshot_version == \
            report.batches[s.batch_idx].snapshot_version
    assert math.isfinite(report.latency["p99"])
