"""Component-aware codec registry + compression planner (paper §3.2–§3.3).

COMPASS's headline space saving comes from *choosing a codec per storage
component by its measured compressibility* — id/adjacency streams and vector
payloads have radically different entropy profiles (cf. Severo et al.,
*Lossless Compression of Vector IDs for ANN Search*). This module is the one
place that choice is made:

- :class:`Codec` — the protocol every codec implements:
  ``encode(record) -> bytes``, ``decode(bytes) -> record``,
  ``estimate_bytes(sample)`` (segment-amortized size estimate).
- The registry maps codec names to instances and components to the codecs
  applicable to them. Canonical component names (shared with
  ``core/storage/blockstore.py``): ``adjacency`` (sorted neighbor-id
  lists), ``ef_slots`` (fixed-size device slot word streams),
  ``pq_codes`` (PQ code rows), ``vector_chunks`` (vector payload byte
  rows), ``permutation`` (the seal-time reorder tables of
  ``core/graph/reorder.py`` — NOT monotone, so only order-agnostic
  codecs apply).
- :func:`plan_components` — the compression planner: sample each
  component, estimate every applicable codec, select the winner, and emit
  a persisted :class:`~repro.core.storage.layout.StorageManifest` that the
  stores build from and ``engine.py`` prices T_DEC from.

Per-record ``encode``/``decode`` are self-describing byte records (what the
4 KiB block store holds); ``estimate_bytes`` models the *segment-amortized*
form where tables/bases are shared across a sample (one Huffman table per
segment, one XOR base per chunk — §3.3), which is what the stores actually
write and therefore what the planner must compare.

A copy of ``repro.core.codec.registry``: the same codecs, names,
``record_bound``s and planner decisions (host numpy).
"""
from __future__ import annotations

import numpy as np

from . import ans
from . import elias_fano as ef
from . import huffman, xor_delta
from .bitpack import pack_fixed, unpack_fixed_np

from ..storage.layout import ComponentPlan, StorageManifest

COMPONENTS = ("adjacency", "ef_slots", "pq_codes", "vector_chunks",
              "permutation")

_DTYPE_BY_ITEMSIZE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _as_uint(values: np.ndarray) -> np.ndarray:
    values = np.asarray(values)
    if values.dtype.kind not in "ui":
        raise TypeError(f"integer codec got dtype {values.dtype}")
    return values.astype(np.uint64)


def _u16_header(n: int, what: str) -> np.ndarray:
    """Record headers carry u16 sizes; a silent wrap would decode a
    truncated record with no error, so oversized records raise."""
    if n > 0xFFFF:
        raise ValueError(f"{what} too large for the u16 record header: "
                         f"{n} > 65535")
    return np.frombuffer(np.uint16(n).tobytes(), np.uint8)


def _min_itemsize(max_value: int) -> int:
    for size in (1, 2, 4, 8):
        if max_value < (1 << (8 * size)):
            return size
    raise ValueError("value out of uint64 range")


class RawCodec:
    """Identity storage: ``u8 itemsize | values``.

    With a declared ``universe`` (id-valued components) ids are stored as
    u32 — the paper's uncompressed ``count + u32 ids`` adjacency form
    (~4(R+1) bytes/list), the same width the co-located baseline charges,
    so a "raw" arm measures *decoupling alone* with no uncredited id-width
    narrowing. Without a universe (byte rows, slot words), the smallest
    covering width is used."""
    name = "raw"
    components = frozenset(COMPONENTS)

    def _itemsize(self, v: np.ndarray, universe: int | None) -> int:
        size = _min_itemsize(int(v.max()) if len(v) else 0)
        if universe is not None:
            size = max(size, 4)
        return size

    def encode(self, values: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        v = _as_uint(values)
        size = self._itemsize(v, universe)
        body = v.astype(_DTYPE_BY_ITEMSIZE[size]).view(np.uint8)
        return np.concatenate([np.asarray([size], np.uint8), body])

    def decode(self, payload: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        payload = np.asarray(payload, np.uint8)
        size = int(payload[0])
        return payload[1:].copy().view(_DTYPE_BY_ITEMSIZE[size]) \
            .astype(np.uint64)

    def estimate_bytes(self, sample: list, *, universe: int | None = None,
                       itemsize: int | None = None) -> int:
        total = 0
        for rec in sample:
            v = _as_uint(rec)
            total += 1 + self._itemsize(v, universe) * len(v)
        return total

    @staticmethod
    def record_bound(r: int, universe: int) -> int:
        """Worst-case record bytes for an R-list (cache entry sizing §3.4):
        header + u32 ids."""
        return 1 + 4 * r


class BitpackCodec:
    """Fixed-width bit packing (§3.2 substrate): ``u8 width | u16 n |
    ceil(n*width/8) packed bytes``. Not a vector_chunks candidate: the
    vector store has no bitpack seal mode, and a planner selection the
    store cannot implement would silently diverge from the latency model's
    manifest pricing (byte rows rarely pack below 8 bits anyway)."""
    name = "bitpack"
    components = frozenset({"adjacency", "ef_slots", "pq_codes",
                            "permutation"})

    def encode(self, values: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        v = _as_uint(values)
        width = max(1, int(v.max()).bit_length()) if len(v) else 1
        n = len(v)
        hdr = np.zeros(3, np.uint8)
        hdr[0] = width
        hdr[1:3] = _u16_header(n, "value count")
        body = pack_fixed(v, width).view(np.uint8)[: (n * width + 7) // 8]
        return np.concatenate([hdr, body])

    def decode(self, payload: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        payload = np.asarray(payload, np.uint8)
        width = int(payload[0])
        n = int(payload[1:3].copy().view(np.uint16)[0])
        body = payload[3:]
        pad = (-len(body)) % 4
        if pad:
            body = np.concatenate([body, np.zeros(pad, np.uint8)])
        return unpack_fixed_np(body.copy().view(np.uint32), n, width)

    def estimate_bytes(self, sample: list, *, universe: int | None = None,
                       itemsize: int | None = None) -> int:
        total = 0
        for rec in sample:
            v = _as_uint(rec)
            width = max(1, int(v.max()).bit_length()) if len(v) else 1
            if width > 33:
                # pack_fixed rejects such widths at encode time; the
                # estimate must too, or the planner could select a codec
                # the store then cannot build with.
                raise ValueError(f"bitpack width {width} unsupported")
            total += 3 + (len(v) * width + 7) // 8
        return total

    @staticmethod
    def record_bound(r: int, universe: int) -> int:
        """Worst-case record bytes for an R-list (cache entry sizing §3.4):
        header + r ids packed at the universe's width."""
        width = max(1, int(universe - 1).bit_length())
        return 3 + (r * width + 7) // 8


class EliasFanoCodec:
    """Monotone id lists (§3.2's auxiliary-index codec) — the compact
    record form of ``elias_fano.encode_record`` (self-describing count +
    low width). Requires the component universe."""
    name = "elias_fano"
    components = frozenset({"adjacency"})

    def encode(self, values: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        if universe is None:
            raise ValueError("elias_fano codec needs a universe")
        return ef.encode_record(np.asarray(values, np.uint64), universe)

    def decode(self, payload: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        if universe is None:
            raise ValueError("elias_fano codec needs a universe")
        return ef.decode_record(np.asarray(payload, np.uint8), universe)

    def estimate_bytes(self, sample: list, *, universe: int | None = None,
                       itemsize: int | None = None) -> int:
        if universe is None:
            universe = 1 + max((int(np.asarray(r).max()) for r in sample
                                if len(np.asarray(r))), default=0)
        return sum(len(self.encode(np.sort(np.asarray(r, np.uint64)),
                                   universe=universe)) for r in sample)

    @staticmethod
    def record_bound(r: int, universe: int) -> int:
        """Worst-case record bytes for an R-list (cache entry sizing §3.4)."""
        return ef.worst_case_record_bytes(r, universe)


class DeltaVarintCodec:
    """Gap coding for *dense* sorted id lists: ``u16 n | LEB128 first |
    LEB128 gaps``. After a locality reorder (``core/graph/reorder.py``)
    within-list gaps collapse to a few bits, so most gaps fit one varint
    byte (~n bytes/list) where Elias-Fano still pays its universe-derived
    low bits + unary high bits. On scattered ids (gap ~ U/R, multi-byte
    varints) it loses to EF and the planner keeps EF — the arbitration the
    reorder flips. Encode requires sorted input (like EF, callers sort);
    ``estimate_bytes`` sorts for the planner's shuffled samples."""
    name = "delta_varint"
    components = frozenset({"adjacency"})

    @staticmethod
    def _leb128_len(x: int) -> int:
        return max(1, (int(x).bit_length() + 6) // 7)

    def encode(self, values: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        v = _as_uint(values)
        if len(v) > 1 and bool(np.any(v[1:] < v[:-1])):
            raise ValueError("delta_varint requires nondecreasing ids")
        out = list(_u16_header(len(v), "value count"))
        prev = 0
        for x in v.tolist():
            gap = int(x) - prev
            prev = int(x)
            while True:
                byte, gap = gap & 0x7F, gap >> 7
                out.append(byte | (0x80 if gap else 0))
                if not gap:
                    break
        return np.asarray(out, np.uint8)

    def decode(self, payload: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        payload = np.asarray(payload, np.uint8)
        n = int(payload[0:2].copy().view(np.uint16)[0])
        out = np.empty(n, np.uint64)
        pos, acc = 2, 0
        for i in range(n):
            gap, shift = 0, 0
            while True:
                byte = int(payload[pos])
                pos += 1
                gap |= (byte & 0x7F) << shift
                shift += 7
                if not byte & 0x80:
                    break
            acc += gap
            out[i] = acc
        return out

    def estimate_bytes(self, sample: list, *, universe: int | None = None,
                       itemsize: int | None = None) -> int:
        total = 0
        for rec in sample:
            v = np.sort(_as_uint(rec))
            gaps = ([int(v[0])] + np.diff(v).tolist()) if len(v) else []
            total += 2 + sum(self._leb128_len(g) for g in gaps)
        return total

    @staticmethod
    def record_bound(r: int, universe: int) -> int:
        """Worst-case record bytes for an R-list (cache entry sizing §3.4):
        every gap at the universe's full varint width."""
        max_bits = max(1, int(max(universe, 2) - 1).bit_length())
        return 2 + r * ((max_bits + 6) // 7)


class AnsIdCodec:
    """rANS-entropy-coded gap stream (Severo et al.) — see
    ``codec/ans.py``. Codes each gap's *bit length* through a parametric
    12-bit rANS model plus raw extra bits, so on reordered graphs where
    the gap distribution concentrates it beats both Elias-Fano (pays
    ceil-log2 universe geometry) and byte-aligned varints (8-bit floor).
    Sorted-input contract identical to ``delta_varint``."""
    name = "ans_id"
    components = frozenset({"adjacency"})

    def encode(self, values: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        return ans.encode_gaps(_as_uint(values))

    def decode(self, payload: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        return ans.decode_gaps(payload)

    def estimate_bytes(self, sample: list, *, universe: int | None = None,
                       itemsize: int | None = None) -> int:
        return sum(len(ans.encode_gaps(np.sort(_as_uint(r))))
                   for r in sample)

    @staticmethod
    def record_bound(r: int, universe: int) -> int:
        return ans.record_bound(r, universe)


class HuffmanCodec:
    """Canonical Huffman over bytes (§3.2's vector-payload codec).

    Self-contained record: ``u8 itemsize | u16 nbytes | 256 code lengths |
    payload`` (conformance form). ``estimate_bytes`` amortizes ONE table
    over the whole sample — the per-segment table the stores persist."""
    name = "huffman"
    components = frozenset({"ef_slots", "pq_codes", "vector_chunks"})

    def _to_bytes(self, values: np.ndarray) -> tuple[np.ndarray, int]:
        values = np.asarray(values)
        if values.dtype.kind not in "ui":
            raise TypeError(f"huffman codec got dtype {values.dtype}")
        return np.ascontiguousarray(values).view(np.uint8).reshape(-1), \
            values.dtype.itemsize

    def encode(self, values: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        b, itemsize = self._to_bytes(values)
        table = huffman.HuffmanTable.from_data(b)
        payload, _ = huffman.encode_records(b[None, :], table) if len(b) \
            else (np.zeros(0, np.uint8), None)
        hdr = np.zeros(3, np.uint8)
        hdr[0] = itemsize
        hdr[1:3] = _u16_header(len(b), "record")
        return np.concatenate([hdr, table.lengths.astype(np.uint8), payload])

    def decode(self, payload: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        payload = np.asarray(payload, np.uint8)
        itemsize = int(payload[0])
        nbytes = int(payload[1:3].copy().view(np.uint16)[0])
        table = huffman.HuffmanTable.from_lengths(
            payload[3:3 + 256].astype(np.int32))
        if nbytes == 0:
            return np.zeros(0, _DTYPE_BY_ITEMSIZE[itemsize]).astype(np.uint64)
        out = huffman.decode_at(payload[3 + 256:], np.zeros(1, np.int64),
                                nbytes, table)[0]
        return out.view(_DTYPE_BY_ITEMSIZE[itemsize]).astype(np.uint64)

    def estimate_bytes(self, sample: list, *, universe: int | None = None,
                       itemsize: int | None = None) -> int:
        rows = [self._to_bytes(r)[0] for r in sample]
        cat = np.concatenate(rows) if rows else np.zeros(0, np.uint8)
        if not len(cat):
            return huffman.NSYM
        table = huffman.HuffmanTable.from_data(cat)
        return huffman.NSYM + sum(
            -(-huffman.encoded_size_bits(r, table) // 8) for r in rows)


class XorDeltaHuffmanCodec:
    """§3.3 two-stage vector codec: XOR against a per-chunk base vector,
    then Huffman. Conformance record embeds base + table (``u16 v | base |
    huffman record``); ``estimate_bytes`` amortizes base + table across the
    sample and applies the sampled-entropy delta test per the paper."""
    name = "xor_delta_huffman"
    components = frozenset({"vector_chunks"})

    def encode(self, values: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        row = np.ascontiguousarray(np.asarray(values)).view(np.uint8) \
            .reshape(-1)
        base = row.copy()                       # single record: base == row
        delta = np.bitwise_xor(row, base)
        hdr = np.zeros(2, np.uint8)
        hdr[0:2] = _u16_header(len(row), "record")
        return np.concatenate([hdr, base, HuffmanCodec().encode(delta)])

    def decode(self, payload: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        payload = np.asarray(payload, np.uint8)
        v = int(payload[0:2].copy().view(np.uint16)[0])
        base = payload[2:2 + v]
        delta = HuffmanCodec().decode(payload[2 + v:]).astype(np.uint8)
        return np.bitwise_xor(delta, base).astype(np.uint64)

    def estimate_bytes(self, sample: list, *, universe: int | None = None,
                       itemsize: int | None = None) -> int:
        rows = [np.ascontiguousarray(np.asarray(r)).view(np.uint8)
                .reshape(1, -1) for r in sample if np.asarray(r).size]
        if not rows:
            return huffman.NSYM
        v = rows[0].shape[1]
        if any(r.shape[1] != v for r in rows):
            # Ragged rows have no shared byte-position base; fall back to
            # plain Huffman pricing + the base-vector overhead.
            return HuffmanCodec().estimate_bytes(sample) + v
        mat = np.concatenate(rows, axis=0)
        use, base = xor_delta.delta_wins(mat)
        data = xor_delta.apply_delta(mat, base) if use else mat
        table = huffman.HuffmanTable.from_data(data)
        per_rec = sum(-(-huffman.encoded_size_bits(row, table) // 8)
                      for row in data)
        return huffman.NSYM + (v if use else 0) + per_rec


class PlaneHuffmanCodec:
    """Per-byte-plane Huffman (``huffman.PlaneTables``): one table per byte
    position mod itemsize. Closes the mixture-vs-columnar entropy gap on
    multi-byte elements (fp32 corpora: exponent planes nearly constant,
    mantissa planes near-uniform — Table 1's columnar concentration) that
    a per-position XOR cannot, since XOR is a bijection per position.
    Conformance record: ``u8 nplanes | u16 nbytes | P*256 lengths |
    payload``; ``estimate_bytes`` amortizes the P tables over the sample.
    Needs ``itemsize`` context (plane count); itemsize 1 degenerates to
    plain Huffman and is left to that codec."""
    name = "plane_huffman"
    components = frozenset({"vector_chunks"})

    def _plane_count(self, values: np.ndarray,
                     itemsize: int | None) -> int:
        values = np.asarray(values)
        if itemsize is not None:
            return int(itemsize)
        return values.dtype.itemsize

    def encode(self, values: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        p = self._plane_count(values, itemsize)
        b = np.ascontiguousarray(np.asarray(values)).view(np.uint8) \
            .reshape(1, -1)
        tables = huffman.PlaneTables.from_data(b, p)
        payload, _ = huffman.encode_records(b, tables)
        hdr = np.zeros(3, np.uint8)
        hdr[0] = p
        hdr[1:3] = _u16_header(b.shape[1], "record")
        lengths = np.concatenate([t.lengths.astype(np.uint8)
                                  for t in tables.tables])
        return np.concatenate([hdr, lengths, payload])

    def decode(self, payload: np.ndarray, *, universe: int | None = None,
               itemsize: int | None = None) -> np.ndarray:
        payload = np.asarray(payload, np.uint8)
        p = int(payload[0])
        nbytes = int(payload[1:3].copy().view(np.uint16)[0])
        tables = huffman.PlaneTables(
            [huffman.HuffmanTable.from_lengths(
                payload[3 + 256 * j:3 + 256 * (j + 1)].astype(np.int32))
             for j in range(p)])
        if nbytes == 0:
            return np.zeros(0, np.uint64)
        out = huffman.decode_at(payload[3 + 256 * p:], np.zeros(1, np.int64),
                                nbytes, tables)[0]
        return out.astype(np.uint64)

    def estimate_bytes(self, sample: list, *, universe: int | None = None,
                       itemsize: int | None = None) -> int:
        if itemsize is None or int(itemsize) <= 1:
            raise ValueError("plane_huffman needs itemsize > 1 context")
        p = int(itemsize)
        rows = [np.ascontiguousarray(np.asarray(r)).view(np.uint8)
                .reshape(-1) for r in sample]
        rows = [r for r in rows if len(r)]
        if not rows or any(len(r) % p for r in rows):
            raise ValueError("rows are not whole multi-byte elements")
        # Rows are whole elements, so concatenation preserves
        # position-mod-p plane alignment.
        cat = np.concatenate(rows)
        tables = huffman.PlaneTables(
            [huffman.HuffmanTable.from_data(cat[j::p]) for j in range(p)])
        return huffman.NSYM * p + sum(
            -(-huffman.encoded_size_bits(r, tables) // 8) for r in rows)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, object] = {}


def register(codec) -> None:
    _REGISTRY[codec.name] = codec


def get(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown codec {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def names() -> list:
    return sorted(_REGISTRY)


def codecs_for(component: str) -> list:
    return [c for _, c in sorted(_REGISTRY.items())
            if component in c.components]


for _codec in (RawCodec(), BitpackCodec(), EliasFanoCodec(),
               DeltaVarintCodec(), AnsIdCodec(), HuffmanCodec(),
               XorDeltaHuffmanCodec(), PlaneHuffmanCodec()):
    register(_codec)


# ---------------------------------------------------------------------------
# Compression planner (§3.2–3.3)
# ---------------------------------------------------------------------------

def plan_components(samples: dict, *, universe: int | None = None,
                    itemsize: int | None = None,
                    sample_limit: int = 512,
                    reorder: str | None = None) -> StorageManifest:
    """Sample each component, estimate every applicable codec, pick the
    winner -> persisted :class:`StorageManifest`.

    ``samples`` maps component name -> list of records (1-D arrays: sorted
    id lists for ``adjacency``, uint32 word streams for ``ef_slots``, uint8
    rows for ``pq_codes``/``vector_chunks``, reorder-table slices for
    ``permutation``). ``universe`` bounds id-valued components (required
    for Elias-Fano to be considered); ``itemsize`` is the vector element
    width in bytes (enables plane-keyed tables on multi-byte elements).
    ``reorder`` records which seal-time ordering the adjacency samples were
    relabeled by (``None`` = external-id layout); it is persisted on the
    manifest so stores built ``from_manifest`` reproduce the layout the
    plan was priced against. Ties break toward the simpler codec (strictly
    smaller wins; equal sizes keep the alphabetically first).
    """
    plans = {}
    for comp, recs in samples.items():
        recs = list(recs)
        if len(recs) > sample_limit:
            # Evenly strided subsample, never a prefix: after a locality
            # reorder the layout concentrates the densest lists at the low
            # positions, so a prefix sample is systematically biased toward
            # whichever codec wins the dense region.
            keep = np.unique(np.linspace(0, len(recs) - 1, sample_limit)
                             .round().astype(np.int64))
            recs = [recs[int(i)] for i in keep]
        recs = [np.asarray(r) for r in recs]
        # The universe bounds ID-VALUED components only; leaking it into
        # byte components would make RawCodec widen uint8 rows to u32 and
        # inflate the raw baseline the decision table is judged against.
        uni = universe if comp in ("adjacency", "permutation") else None
        candidates = {}
        for codec in codecs_for(comp):
            try:
                candidates[codec.name] = int(codec.estimate_bytes(
                    recs, universe=uni, itemsize=itemsize))
            except (TypeError, ValueError):
                continue        # codec not applicable to this data shape
        if not candidates:
            raise ValueError(f"no codec applicable to component {comp!r}")
        raw_bytes = candidates.get(
            "raw", int(sum(np.asarray(r).nbytes for r in recs)))
        winner = min(sorted(candidates), key=candidates.get)
        params = {}
        if universe is not None and comp in ("adjacency", "permutation"):
            params["universe"] = int(universe)
        if itemsize is not None and comp == "vector_chunks":
            params["itemsize"] = int(itemsize)
        plans[comp] = ComponentPlan(
            component=comp, codec=winner, raw_bytes=raw_bytes,
            est_bytes=candidates[winner], candidates=candidates,
            params=params)
    return StorageManifest(components=plans, reorder=reorder)
