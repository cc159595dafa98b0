"""Port parity tier for the autotune cache (``repro_torch.kernels.
autotune``): the 12 cases of tests/test_autotune.py on the port, each held
against the reference's ``AutotuneCache`` on the same records where both
take them (the reference's ``pallas`` column is the port's ``cuda``), plus
the port's own rules: a ``cuda:`` key never records or picks ``ref``, a
cache of another platform loads as empty, the cache path is an argument
(no environment variable), and ``auto-tuned`` resolves to ``auto`` or
``off`` at config time."""
import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jauto

from repro_torch.core.search import beam
from repro_torch.kernels import autotune
from repro_torch.kernels.autotune import (AutotuneCache, bucket_dims,
                                          bucket_key, _log_distance,
                                          _parse_key)
from repro_torch.kernels.dispatch import KernelConfig, resolve_backend

CARD = "cuda:NVIDIA H100 80GB HBM3"
#: the reference's backend name -> the port's
PORT_NAME = {"ref": "ref", "off": "off", "pallas": "cuda"}


def _records():
    """tests/test_autotune.py's records, in the reference's names."""
    return [("pq_adc", "ref", 500.0, dict(n=1024, m=8, k=256)),
            ("pq_adc", "pallas", 1100.0, dict(n=1024, m=8, k=256)),
            ("pq_adc", "ref", 800.0, dict(n=4096, m=8, k=256)),
            ("pq_adc", "pallas", 6100.0, dict(n=4096, m=8, k=256)),
            ("ef_decode", "ref", 7000.0, dict(lists=256, r=32)),
            ("ef_decode", "pallas", 590.0, dict(lists=256, r=32)),
            ("beam_step", "off", 5200.0, dict(nq=32, e=64, l=48, m=8)),
            ("beam_step", "ref", 9900.0, dict(nq=32, e=64, l=48, m=8)),
            ("beam_step", "pallas", 15000.0, dict(nq=32, e=64, l=48, m=8))]


def _cache(platform="cpu"):
    c = AutotuneCache(platform=platform)
    for op, backend, us, dims in _records():
        c.record(op, PORT_NAME[backend], us, **dims)
    return c


def _ref_cache():
    c = jauto.AutotuneCache(platform="cpu")
    for op, backend, us, dims in _records():
        c.record(op, backend, us, **dims)
    return c


def _card_cache():
    """A cuda-keyed cache: the fused kernel against the unfused hop."""
    c = AutotuneCache(platform=CARD)
    c.record("beam_step", "cuda", 61.0, nq=1024, e=512, l=200, m=32)
    c.record("beam_step", "off", 90.0, nq=1024, e=512, l=200, m=32)
    c.record("beam_step", "cuda", 30.0, nq=8, e=512, l=200, m=32)
    c.record("beam_step", "off", 20.0, nq=8, e=512, l=200, m=32)
    return c


# ------------------------------------------------------------------ buckets
def test_bucket_dims_power_of_two():
    assert bucket_dims(n=1000, m=8) == {"n": 1024, "m": 8}
    assert bucket_dims(n=1025) == {"n": 2048}
    assert bucket_dims(n=1) == {"n": 1}
    assert bucket_key("op", b=2, a=1) == bucket_key("op", a=1, b=2)
    assert bucket_key("pq_adc", n=900, m=8) == bucket_key("pq_adc",
                                                          n=1024, m=8)
    rng = np.random.default_rng(0)
    for _ in range(200):
        dims = {k: int(v) for k, v in zip("nmkq", rng.integers(1, 1 << 20,
                                                                 4))}
        assert bucket_dims(**dims) == jauto.bucket_dims(**dims)
        assert bucket_key("op", **dims) == jauto.bucket_key("op", **dims)
        key = bucket_key("op", **dims)
        assert _parse_key(key) == jauto._parse_key(key)


def test_log_distance_prefers_shared_dims():
    a = bucket_dims(n=1024, m=8)
    assert _log_distance(a, bucket_dims(n=2048, m=8)) == 1.0
    assert _log_distance(a, bucket_dims(n=1024, m=16)) == 1.0
    assert _log_distance(a, bucket_dims(n=1024)) == 4.0
    for b in (dict(n=4096, m=2), dict(k=3), dict(n=1, m=1, k=1)):
        assert _log_distance(a, bucket_dims(**b)) == \
            jauto._log_distance(a, jauto.bucket_dims(**b))


# ------------------------------------------------------------- round-trip
def test_cache_round_trip(tmp_path):
    c = _cache()
    path = tmp_path / "cache.json"
    c.save(path)
    loaded = AutotuneCache.load(path, platform="cpu")
    assert loaded.entries == c.entries
    assert loaded.best("pq_adc", dict(n=1024, m=8, k=256)) == "ref"
    p2 = tmp_path / "cache2.json"
    loaded.save(p2)
    assert path.read_text() == p2.read_text()
    # the reference's file format: the reference loads what the port saved
    ref_view = jauto.AutotuneCache.load(path, platform="cpu")
    assert set(ref_view.entries) == set(c.entries)


def test_cache_platform_mismatch_is_empty(tmp_path):
    """A CPU cache never places a CUDA kernel: under a cuda: key it loads
    as empty, and so does one of another card."""
    path = tmp_path / "cache.json"
    _cache(platform="cpu").save(path)
    card_view = AutotuneCache.load(path, platform=CARD)
    assert card_view.entries == {}
    assert card_view.best("pq_adc", dict(n=1024, m=8, k=256),
                          fallback="cuda") == "cuda"
    _card_cache().save(path)
    assert AutotuneCache.load(path, platform="cpu").entries == {}
    assert AutotuneCache.load(path, platform="cuda:another card").entries \
        == {}
    assert AutotuneCache.load(path, platform=CARD).entries \
        == _card_cache().entries


def test_cache_missing_or_corrupt_is_empty(tmp_path):
    assert AutotuneCache.load(tmp_path / "nope.json", "cpu").entries == {}
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert AutotuneCache.load(bad, "cpu").entries == {}
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"version": -1, "platform": "cpu",
                                 "entries": {"x|n=1": {"us": {"ref": 1}}}}))
    assert AutotuneCache.load(stale, "cpu").entries == {}


def test_record_keeps_minimum():
    c = AutotuneCache(platform="cpu")
    c.record("pq_adc", "ref", 900.0, n=1024, m=8, k=256)
    c.record("pq_adc", "ref", 500.0, n=1024, m=8, k=256)
    c.record("pq_adc", "ref", 800.0, n=1000, m=8, k=256)
    key = bucket_key("pq_adc", n=1024, m=8, k=256)
    assert c.entries[key]["us"]["ref"] == 500.0


# ------------------------------------------------------------- resolution
def test_best_is_deterministic_and_never_loses():
    """The same picks as the reference's cache on the same records, every
    time, and each pick has its bucket's minimum time."""
    c, ref = _cache(), _ref_cache()
    for _ in range(3):
        assert c.best("pq_adc", dict(n=1024, m=8, k=256)) == "ref"
        assert c.best("ef_decode", dict(lists=256, r=32)) == "cuda"
        assert c.best("beam_step", dict(nq=32, e=64, l=48, m=8)) == "off"
    for key, entry in c.entries.items():
        pick = c._argmin(entry)
        assert entry["us"][pick] == min(entry["us"].values())
    rng = np.random.default_rng(1)
    for op in ("pq_adc", "ef_decode", "beam_step", "no_such_op"):
        assert c.best(op) == PORT_NAME[ref.best(op)]
        for _ in range(20):
            dims = dict(n=int(rng.integers(1, 1 << 14)), m=8, k=256,
                        lists=int(rng.integers(1, 1024)), r=32)
            assert c.best(op, dims) == PORT_NAME[ref.best(op, dims)]


def test_best_tie_breaks_to_ref():
    c = AutotuneCache(platform="cpu")
    c.record("op", "cuda", 100.0, n=8)
    c.record("op", "ref", 100.0, n=8)
    c.record("op2", "cuda", 100.0, n=8)
    c.record("op2", "off", 100.0, n=8)
    assert c.best("op", dict(n=8)) == "ref"
    assert c.best("op2", dict(n=8)) == "off"


def test_bucket_fallback_nearest_then_majority():
    c = _cache()
    assert c.best("pq_adc", dict(n=16384, m=8, k=256)) == "ref"
    assert c.best("pq_adc") == "ref"
    assert c.best("ef_decode") == "cuda"
    assert c.best("no_such_op", dict(n=4)) == "ref"
    assert c.best("no_such_op", fallback="cuda") == "cuda"


# ------------------------------------------------- dispatch integration
def test_auto_tuned_resolution_through_dispatch(tmp_path):
    """The cache path is an argument: 'auto-tuned' resolves per op from
    it at config time, to 'off' where the unfused hop won and to 'auto'
    elsewhere; resolution is idempotent, and a config still holding
    'auto-tuned' cannot reach a kernel."""
    path = tmp_path / "cache.json"
    _cache(platform="cpu").save(path)
    cfg = KernelConfig(*(["auto-tuned"] * 5)).resolve("cpu", cache=path)
    assert cfg == KernelConfig("auto", "auto", "auto", "auto", "off")
    assert cfg.resolve("cpu", cache=path) == cfg
    shaped = KernelConfig(*(["auto-tuned"] * 5)).resolve(
        "cpu", shapes={"beam_step": dict(nq=32, e=64, l=48, m=8)},
        cache=AutotuneCache.load(path, "cpu"))
    assert shaped.beam_step == "off"
    p = beam.SearchParams(kernels=KernelConfig(beam_step="auto-tuned"))
    assert beam.resolve_kernels(p, "cpu", cache=path).kernels.beam_step \
        == "off"
    with pytest.raises(RuntimeError, match="auto-tuned"):
        resolve_backend("auto-tuned", torch.device("cpu"), "beam_step")
    with pytest.raises(RuntimeError, match="auto-tuned"):
        beam.check_kernels(p)       # the search's own per-call check
    with pytest.raises(ValueError, match="unknown"):
        KernelConfig(pq_adc="pallas").resolve("cpu")


def test_auto_tuned_empty_cache_falls_back_to_auto(tmp_path):
    """An empty cache (missing, or another platform's) resolves like
    'auto': the backend of the tensors' device."""
    missing = tmp_path / "missing.json"
    cfg = KernelConfig(*(["auto-tuned"] * 5)).resolve("cpu", cache=missing)
    assert cfg == KernelConfig()
    assert resolve_backend(cfg.pq_adc, torch.device("cpu"), "pq_adc") \
        == "ref"
    _card_cache().save(tmp_path / "card.json")
    assert KernelConfig(beam_step="auto-tuned").resolve(
        "cpu", cache=tmp_path / "card.json") == KernelConfig()
    assert KernelConfig(beam_step="auto-tuned").resolve(
        "cpu", cache=_card_cache()) == KernelConfig()


def test_committed_cache_never_loses_its_bench():
    """The shipped cache (kernels/autotune_cache.json): measured on the
    card, keyed by it, no plain version in it, and every pick the measured
    argmin."""
    doc = json.loads(autotune.DEFAULT_CACHE_PATH.read_text())
    assert doc["version"] == autotune.CACHE_VERSION
    assert doc["platform"].startswith("cuda:"), doc["platform"]
    cache = AutotuneCache.load(autotune.DEFAULT_CACHE_PATH,
                               platform=doc["platform"])
    assert cache.entries, "committed cache is empty — rerun chip_smoke.py"
    assert cache.entries == {k: v for k, v in doc["entries"].items()}
    for key, entry in cache.entries.items():
        assert "ref" not in entry["us"], key
        pick = cache._argmin(entry)
        assert entry["us"][pick] == min(entry["us"].values()), key
    assert {_parse_key(k)[0] for k in cache.entries} == {"beam_step"}


# ------------------------------------------------------- the card's rules
def test_card_key_never_records_or_picks_ref(tmp_path):
    c = _card_cache()
    with pytest.raises(ValueError, match="never a contender"):
        c.record("beam_step", "ref", 1.0, nq=8, e=512, l=200, m=32)
    assert c.best("beam_step", dict(nq=1024, e=512, l=200, m=32)) == "cuda"
    assert c.best("beam_step", dict(nq=8, e=512, l=200, m=32)) == "off"
    # a cuda-keyed file holding a plain timing drops it on load
    path = tmp_path / "card.json"
    doc = json.loads(c.save(path).read_text())
    for entry in doc["entries"].values():
        entry["us"]["ref"] = 0.001
    path.write_text(json.dumps(doc))
    loaded = AutotuneCache.load(path, platform=CARD)
    assert loaded.entries == c.entries
    for dims in (dict(nq=1024, e=512, l=200, m=32),
                 dict(nq=8, e=512, l=200, m=32), None):
        assert loaded.best("beam_step", dims) in ("cuda", "off")


def test_platform_key():
    assert autotune.platform_key(torch.device("cpu")) == "cpu"
    with pytest.raises(ValueError, match="no kernel backend"):
        autotune.platform_key(torch.device("meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            autotune.AutotuneCache.load()
