"""Persisted per-(op, shape-bucket) backend autotuning — the port of
``repro.kernels.autotune``.

A measurement-driven rule beside the device rule of ``dispatch.py``:

- A timing run (``chip_smoke.py``'s phase 5 on the card) times each
  contender of an op at the shapes the search gives it and records the
  medians here (``AutotuneCache.record``).
- The cache is persisted as JSON (``save``/``load``) and shipped with the
  package (``kernels/autotune_cache.json``). Its path is an argument: the
  kernel layer reads no environment variable.
- An ``auto-tuned`` entry in ``KernelConfig`` resolves per (op,
  shape-bucket) to the contender with the LOWEST measured time, so a
  resolved config never picks a contender that lost its bucket. Shapes are
  bucketed by rounding each dim up to a power of two; an unseen shape takes
  the nearest measured bucket of the same op (log-distance), then the
  op's ``auto`` rule when the op has no measurements at all.

Cache entries are keyed by platform (:func:`platform_key`): ``cpu``, or
``cuda:`` plus the card's name. A cache measured elsewhere loads as empty,
so timings of the plain versions on the CPU never place a CUDA kernel. On a
``cuda:`` key the plain version (``ref``) is never recorded and never
chosen: the card runs its CUDA kernels, and the one real choice there is
``beam_step`` fused (``cuda``) against the unfused composition (``off``).

Determinism: same shapes -> same bucket -> same argmin (ties break by
backend order, ``ref`` first), so a config resolved twice is identical —
resolution stays config-time, like ``auto``.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from .dispatch import resolve_device

DEFAULT_CACHE_PATH = Path(__file__).resolve().parent / "autotune_cache.json"
CACHE_VERSION = 1

# Backend preference order for argmin tie-breaks (ref first: the plain
# version, deployable everywhere). "off" is the beam_step pseudo-backend —
# the UNFUSED op composition — timed against the fused kernel.
_ORDER = ("ref", "off", "cuda")


def platform_key(device: torch.device) -> str:
    """The cache key of the platform whose tensors live on ``device``:
    ``cuda:<device name>`` or ``cpu``."""
    if device.type == "cuda":
        return "cuda:" + torch.cuda.get_device_name(device)
    if device.type == "cpu":
        return "cpu"
    raise ValueError(f"no kernel backend for tensors on {device}")


def _on_card(platform: str) -> bool:
    return platform.startswith("cuda:")


def bucket_dims(**dims) -> dict:
    """Round every dim up to the next power of two (1 stays 1). Two shapes
    in the same bucket are expected to prefer the same backend; the bucket
    string is the cache key."""
    return {k: 1 << max(0, math.ceil(math.log2(max(1, int(v)))))
            for k, v in dims.items()}


def bucket_key(op: str, **dims) -> str:
    b = bucket_dims(**dims)
    return op + "|" + ";".join(f"{k}={v}" for k, v in sorted(b.items()))


def _log_distance(a: dict, b: dict) -> float:
    """Distance between two buckets of the same op: sum of |log2 dim
    ratios| over shared keys, +4 per unshared key (a different dim set is
    a worse match than any 16x size difference on a shared dim)."""
    keys = set(a) | set(b)
    d = 0.0
    for k in keys:
        if k in a and k in b:
            d += abs(math.log2(max(1, a[k])) - math.log2(max(1, b[k])))
        else:
            d += 4.0
    return d


def _parse_key(key: str) -> tuple[str, dict]:
    op, _, rest = key.partition("|")
    dims = {}
    for part in rest.split(";"):
        if part:
            k, _, v = part.partition("=")
            dims[k] = int(v)
    return op, dims


class AutotuneCache:
    """In-memory view of the persisted (op, shape-bucket) -> timings table."""

    def __init__(self, platform: str, entries: dict | None = None):
        self.platform = platform
        # key "op|d1=v1;d2=v2" -> {"us": {backend: µs}}
        self.entries: dict[str, dict] = entries or {}

    # ------------------------------------------------------------- persist
    @classmethod
    def load(cls, path: str | Path | None = None,
             platform: str | None = None) -> "AutotuneCache":
        """Load the cache for ``platform`` (None = the card's key) from
        ``path`` (None = the committed cache). A missing or unreadable
        file, another version or another platform yields an EMPTY cache
        (resolution falls back to the ``auto`` rule) — never an error and
        never another platform's numbers. A ``cuda:`` cache drops any
        ``ref`` timing it holds."""
        if platform is None:
            platform = platform_key(resolve_device())
        path = Path(path or DEFAULT_CACHE_PATH)
        try:
            doc = json.loads(path.read_text())
        except (OSError, ValueError):
            return cls(platform)
        if doc.get("version") != CACHE_VERSION \
                or doc.get("platform") != platform:
            return cls(platform)
        entries = {}
        for k, v in doc.get("entries", {}).items():
            us = {b: t for b, t in v.get("us", {}).items()
                  if not (_on_card(platform) and b == "ref")}
            if us:
                entries[k] = {"us": us}
        return cls(platform, entries)

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        doc = {
            "version": CACHE_VERSION,
            "platform": self.platform,
            "note": ("per-(op, shape-bucket) measured µs (median device "
                     "time); trusted only on its own platform (see "
                     "kernels/autotune.py)"),
            "entries": {k: self.entries[k] for k in sorted(self.entries)},
        }
        path.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
        return path

    # -------------------------------------------------------------- record
    def record(self, op: str, backend: str, us: float, **dims) -> None:
        if _on_card(self.platform) and backend == "ref":
            raise ValueError(
                f"the plain version is never a contender on the card "
                f"({self.platform}): record 'cuda' or 'off', not 'ref'")
        key = bucket_key(op, **dims)
        entry = self.entries.setdefault(key, {"us": {}})
        # Keep the best (lowest) time seen for the bucket: re-timing a
        # bucket with a different concrete shape must not let one noisy
        # slow sample evict a demonstrated-fast backend.
        prev = entry["us"].get(backend)
        entry["us"][backend] = round(us, 3) if prev is None \
            else min(prev, round(us, 3))

    # -------------------------------------------------------------- choose
    def _argmin(self, entry: dict) -> str:
        us = entry["us"]
        return min(sorted(us, key=lambda b: _ORDER.index(b)
                          if b in _ORDER else len(_ORDER)),
                   key=lambda b: us[b])

    def best(self, op: str, dims: dict | None = None,
             fallback: str = "ref") -> str:
        """Backend with the lowest measured time for (op, bucket-of-dims).

        Lookup order: exact bucket -> nearest measured bucket of the same
        op (log-distance over dims; deterministic tie-break by key) ->
        majority vote over the op's buckets when no dims are given ->
        ``fallback`` when the op has no measurements. The argmin can by
        construction never return a backend that lost its own bucket."""
        mine = {k: v for k, v in self.entries.items()
                if _parse_key(k)[0] == op}
        if not mine:
            return fallback
        if dims:
            key = bucket_key(op, **dims)
            if key in mine:
                return self._argmin(mine[key])
            want = bucket_dims(**dims)
            near = min(sorted(mine),
                       key=lambda k: (_log_distance(want,
                                                    _parse_key(k)[1]), k))
            return self._argmin(mine[near])
        # No shape hint: majority vote across the op's measured buckets,
        # ties to _ORDER.
        votes: dict[str, int] = {}
        for k in sorted(mine):
            b = self._argmin(mine[k])
            votes[b] = votes.get(b, 0) + 1
        return max(sorted(votes, key=lambda b: _ORDER.index(b)
                          if b in _ORDER else len(_ORDER)),
                   key=lambda b: votes[b])
