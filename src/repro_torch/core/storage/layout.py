"""Hierarchical layout arithmetic + 4 KiB block packing (paper §3.3).

The paper's closed forms, implemented exactly:

- chunk-metadata overhead ratio  β = (V + 12)/C + α/1024
- chunk size from a user budget  C = (V + 12)/(β − α/1024)
- per-chunk metadata bytes       4·(αC/4096 + 3) + V
- EF worst case                  2R + R·ceil(log2(N/R)) bits
- sparse index worst case        ceil(N·EF_bits / 8192) bytes

Blocks are the minimum I/O unit (4 KiB). A block holds whole records
(records never span blocks → the internal fragmentation the paper measures)
preceded by a block header: u16 count + per-record (u32 id, u16 offset).

Everything up to the torch section is a copy of
``repro.core.storage.layout`` (numpy, host). ``pack_blocks_torch`` is the
greedy first-fit of :func:`pack_blocks` for tensors: the same blocks and
bytes for a shard's tens of millions of records, with no Python step per
record or per block.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

BLOCK_SIZE = 4096
_HDR_FIXED = 2            # u16 record count
_HDR_PER_REC = 6          # u32 id + u16 byte offset


def beta_for_chunk(c_bytes: int, v_bytes: int, alpha: float = 1.0) -> float:
    """β = (V+12)/C + α/1024 (paper §3.3)."""
    return (v_bytes + 12) / c_bytes + alpha / 1024.0


def chunk_size_for_beta(beta: float, v_bytes: int, alpha: float = 1.0) -> int:
    """Solve β for C. With unknown α, α=1 is the conservative bound."""
    denom = beta - alpha / 1024.0
    if denom <= 0:
        raise ValueError(f"beta {beta} infeasible for alpha {alpha} "
                         f"(needs beta > alpha/1024)")
    return int(round((v_bytes + 12) / denom))


def chunk_metadata_bytes(c_bytes: int, v_bytes: int, alpha: float = 1.0) -> int:
    """4*(αC/4096 + 3) + V bytes per chunk (paper §3.3)."""
    return int(4 * (alpha * c_bytes / BLOCK_SIZE + 3) + v_bytes)


@dataclass
class PackedBlocks:
    """Records packed into 4 KiB blocks (one physical byte image).

    In-order packings (:func:`pack_blocks`) keep ``rec_block``
    non-decreasing and ``block_first_id`` sorted, so a plain boundary
    search (:func:`locate_block`) maps ids to blocks. Co-resident packings
    (:func:`pack_blocks_coresident`) group each record with its graph
    neighbors instead, so a block holds a non-consecutive id set; the
    sparse index then stays sorted via the *runs* indirection —
    ``run_first_id`` (sorted maximal same-block id runs) pointing into
    ``run_block`` (:func:`locate_block_runs`)."""
    data: np.ndarray          # uint8 [n_blocks * BLOCK_SIZE]
    n_blocks: int
    rec_block: np.ndarray     # [m] int32 block index per record
    rec_start: np.ndarray     # [m] int64 absolute payload offset in `data`
    rec_len: np.ndarray       # [m] int32
    block_first_id: np.ndarray  # [n_blocks] int64 (boundary ids, §3.3)
    run_first_id: np.ndarray = None   # [n_runs] sorted first id per run
    run_block: np.ndarray = None      # [n_runs] block of each run

    @property
    def coresident(self) -> bool:
        return self.run_first_id is not None

    @property
    def physical_bytes(self) -> int:
        return self.n_blocks * BLOCK_SIZE

    def record_bytes(self, i: int) -> np.ndarray:
        s = int(self.rec_start[i])
        return self.data[s:s + int(self.rec_len[i])]


def block_bytes_needed(n_records: int, payload_bytes: int,
                       implicit_ids: bool = False) -> int:
    """Bytes one block needs for ``n_records`` totalling ``payload_bytes``."""
    per_rec = 2 if implicit_ids else _HDR_PER_REC
    hdr = (_HDR_FIXED + 4) if implicit_ids else _HDR_FIXED
    return hdr + n_records * per_rec + payload_bytes


def pack_block_image(ids: np.ndarray, records: list,
                     implicit_ids: bool = False
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Serialize ONE block's records -> (image uint8[BLOCK_SIZE],
    payload offsets int64[len(records)] within the block).

    The single definition of the on-disk block format — used by
    :func:`pack_blocks` for fresh builds and by
    ``CompressedIndexStore.rewrite_blocks`` for in-place dirty-block
    repacking, so the two can never diverge."""
    per_rec = 2 if implicit_ids else _HDR_PER_REC
    hdr_fixed = (_HDR_FIXED + 4) if implicit_ids else _HDR_FIXED
    cnt = len(records)
    img = np.zeros(BLOCK_SIZE, dtype=np.uint8)
    img[0:2] = np.frombuffer(np.uint16(cnt).tobytes(), dtype=np.uint8)
    if implicit_ids:
        img[2:6] = np.frombuffer(np.uint32(ids[0]).tobytes(), np.uint8)
    off = hdr_fixed + cnt * per_rec
    offsets = np.zeros(cnt, dtype=np.int64)
    for j, (vid, rec) in enumerate(zip(ids, records)):
        h = hdr_fixed + j * per_rec
        if not implicit_ids:
            img[h:h + 4] = np.frombuffer(np.uint32(vid).tobytes(), np.uint8)
            img[h + 4:h + 6] = np.frombuffer(np.uint16(off).tobytes(), np.uint8)
        else:
            img[h:h + 2] = np.frombuffer(np.uint16(off).tobytes(), np.uint8)
        rec = np.frombuffer(bytes(rec), dtype=np.uint8) \
            if not isinstance(rec, np.ndarray) else rec
        if off + len(rec) > BLOCK_SIZE:
            raise ValueError("records overflow the block")
        img[off:off + len(rec)] = rec
        offsets[j] = off
        off += len(rec)
    return img, offsets


def pack_blocks(ids: np.ndarray, records: list[bytes | np.ndarray],
                implicit_ids: bool = False,
                fill_factor: float = 1.0) -> PackedBlocks:
    """Greedy first-fit packing of (id-ordered) variable-size records.

    ``implicit_ids=True`` is the auxiliary-index layout (§3.3): vertex IDs
    are dense/consecutive, so the block header stores only the first id +
    u16 record offsets (the per-record u32 id column is elided).

    ``fill_factor < 1`` caps the *build-time* fill of each block, leaving
    headroom so records can grow in place later (the block-granular
    incremental rewrite of ``CompressedIndexStore.rewrite_blocks``); a
    single record is always admitted to an empty block regardless.
    """
    m = len(records)
    ids = np.asarray(ids, dtype=np.int64)
    per_rec = 2 if implicit_ids else _HDR_PER_REC
    hdr_fixed = (_HDR_FIXED + 4) if implicit_ids else _HDR_FIXED
    lens = np.array([len(r) for r in records], dtype=np.int64)
    if np.any(lens + hdr_fixed + per_rec > BLOCK_SIZE):
        raise ValueError("record larger than a block")
    if not 0.0 < fill_factor <= 1.0:
        raise ValueError(f"fill_factor must be in (0, 1], got {fill_factor}")
    limit = int(BLOCK_SIZE * fill_factor)
    rec_block = np.zeros(m, np.int32)
    blocks: list[list[int]] = []
    used = BLOCK_SIZE + 1  # force new block at first record
    for i in range(m):
        need = per_rec + int(lens[i])
        # Open a fresh block once the fill cap would be exceeded; the
        # unconditional append below means a freshly opened block always
        # admits its first record, even past the cap (records are already
        # checked to fit a raw block).
        if used + need > limit:
            blocks.append([])
            used = hdr_fixed
        blocks[-1].append(i)
        used += need
        rec_block[i] = len(blocks) - 1
    n_blocks = len(blocks)
    data = np.zeros(n_blocks * BLOCK_SIZE, dtype=np.uint8)
    rec_start = np.zeros(m, np.int64)
    block_first_id = np.zeros(n_blocks, np.int64)
    for b, members in enumerate(blocks):
        base = b * BLOCK_SIZE
        img, offsets = pack_block_image(ids[members],
                                        [records[i] for i in members],
                                        implicit_ids)
        data[base:base + BLOCK_SIZE] = img
        block_first_id[b] = ids[members[0]]
        for j, i in enumerate(members):
            rec_start[i] = base + offsets[j]
    return PackedBlocks(data=data, n_blocks=n_blocks, rec_block=rec_block,
                        rec_start=rec_start, rec_len=lens.astype(np.int32),
                        block_first_id=block_first_id)


def locate_block(block_first_id: np.ndarray, vector_id: int) -> int:
    """Sparse-index lookup: boundary ids -> block index (§3.3)."""
    b = int(np.searchsorted(block_first_id, vector_id, side="right")) - 1
    return max(b, 0)


def id_runs(ids: np.ndarray, rec_block: np.ndarray
            ) -> tuple[np.ndarray, np.ndarray]:
    """Runs sparse index for an arbitrary id->block assignment: walk the
    ids in sorted order and cut a run wherever the block changes. Returns
    ``(run_first_id, run_block)`` — the boundary array stays sorted (the
    §3.3 searchsorted lookup survives co-resident packing), and the block
    column is the indirection table. For an in-order packing this
    degenerates to exactly one run per block."""
    ids = np.asarray(ids, np.int64)
    rec_block = np.asarray(rec_block, np.int64)
    if not len(ids):
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    order = np.argsort(ids, kind="stable")
    sid, sblk = ids[order], rec_block[order]
    cut = np.flatnonzero(np.diff(sblk) != 0) + 1
    starts = np.concatenate([[0], cut])
    return sid[starts].astype(np.int64), sblk[starts].astype(np.int32)


def locate_block_runs(run_first_id: np.ndarray, run_block: np.ndarray,
                      vector_id: int) -> int:
    """Sparse-index lookup through the runs indirection table: sorted
    boundary search, then one indexed read of the block column."""
    r = int(np.searchsorted(run_first_id, vector_id, side="right")) - 1
    return int(run_block[max(r, 0)])


def pack_blocks_coresident(ids: np.ndarray,
                           records: list[bytes | np.ndarray],
                           neighbors: list,
                           fill_factor: float = 1.0) -> PackedBlocks:
    """Greedy co-residency packing: group each record into the same 4 KiB
    block as its hottest in-order graph neighbors, so one block read
    serves several members of a beam hop's frontier.

    ``neighbors[i]`` lists the RECORD INDICES adjacent to record ``i``
    (for a seal-ordered store these are internal positions — the packing
    composes with bfs/bisection/minla orderings, which is what makes
    "nearest position" a good hotness proxy). Seeds are taken in record
    order; each open block greedily admits the unplaced neighbor of its
    members whose position is closest to the seed (ties to the lower id)
    until the fill cap is reached. Every record keeps its array slot:
    ``rec_block``/``rec_start`` stay indexed by record position, only the
    physical placement is grouped.

    Block images use the explicit-id header layout (member ids are not
    consecutive, so the implicit-id elision of :func:`pack_blocks` cannot
    apply — 6 B/record instead of 2 B; the runs sparse index prices the
    rest of the difference). ``run_first_id``/``run_block`` are populated
    for the sorted-boundary lookup."""
    import heapq as _hq

    m = len(records)
    ids = np.asarray(ids, dtype=np.int64)
    lens = np.array([len(r) for r in records], dtype=np.int64)
    if np.any(lens + _HDR_FIXED + _HDR_PER_REC > BLOCK_SIZE):
        raise ValueError("record larger than a block")
    if not 0.0 < fill_factor <= 1.0:
        raise ValueError(f"fill_factor must be in (0, 1], got {fill_factor}")
    limit = int(BLOCK_SIZE * fill_factor)
    placed = np.full(m, -1, np.int32)       # record -> block
    blocks: list[list[int]] = []
    for seed in range(m):
        if placed[seed] >= 0:
            continue
        b = len(blocks)
        blocks.append([seed])
        placed[seed] = b
        used = _HDR_FIXED + _HDR_PER_REC + int(lens[seed])
        # Hotness heap over unplaced neighbors of current members:
        # closest in-order position to the seed first.
        heap: list[tuple[int, int]] = []
        for v in neighbors[seed]:
            v = int(v)
            if 0 <= v < m and placed[v] < 0:
                _hq.heappush(heap, (abs(v - seed), v))
        while heap:
            _, cand = _hq.heappop(heap)
            if placed[cand] >= 0:
                continue
            need = _HDR_PER_REC + int(lens[cand])
            if used + need > limit:
                continue            # try a smaller/closer record instead
            blocks[b].append(cand)
            placed[cand] = b
            used += need
            for v in neighbors[cand]:
                v = int(v)
                if 0 <= v < m and placed[v] < 0:
                    _hq.heappush(heap, (abs(v - seed), v))
    n_blocks = len(blocks)
    data = np.zeros(n_blocks * BLOCK_SIZE, dtype=np.uint8)
    rec_start = np.zeros(m, np.int64)
    block_first_id = np.zeros(n_blocks, np.int64)
    for b, members in enumerate(blocks):
        members = sorted(members)
        base = b * BLOCK_SIZE
        img, offsets = pack_block_image(ids[members],
                                        [records[i] for i in members],
                                        implicit_ids=False)
        data[base:base + BLOCK_SIZE] = img
        block_first_id[b] = ids[members[0]]
        for j, i in enumerate(members):
            rec_start[i] = base + offsets[j]
    run_first_id, run_block = id_runs(ids, placed)
    return PackedBlocks(data=data, n_blocks=n_blocks,
                        rec_block=placed.astype(np.int32),
                        rec_start=rec_start, rec_len=lens.astype(np.int32),
                        block_first_id=block_first_id,
                        run_first_id=run_first_id, run_block=run_block)


# ---------------------------------------------------------------------------
# Block packing on tensors
# ---------------------------------------------------------------------------

def _block_starts(need: torch.Tensor, cap: int,
                  breaks: torch.Tensor | None = None) -> torch.Tensor:
    """First record of every block of the greedy first-fit, in order.

    ``need[i]`` is record i's bytes in a block (its payload + its header
    entry), ``cap`` the bytes a block has for them. A block opened at
    record s takes s and then every following record while the running sum
    fits ``cap`` (an empty block admits its first record whatever its
    size), and never reaches past the next ``breaks`` entry (chunk starts:
    blocks never span chunks). Because records are taken in order, a
    block's end is a search in the cumulative sizes, so every possible
    block is known at once: ``nxt[s]`` is the start of the block after a
    block opened at s. The blocks are the orbit of record 0 under ``nxt``,
    found by pointer doubling: after step k the set holds the first 2**k
    starts, and ``jump`` is ``nxt`` applied 2**k times.
    """
    m = need.shape[0]
    dev = need.device
    if m == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    cum = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    torch.cumsum(need.to(torch.int64), 0, out=cum[1:])
    s = torch.arange(m, device=dev)
    end = torch.searchsorted(cum, cum[:-1] + cap, right=True) - 1
    end = torch.maximum(end, s + 1)
    if breaks is not None and breaks.numel():
        nb = torch.searchsorted(breaks, s, right=True)
        bound = torch.cat([breaks, torch.tensor([m], device=dev)])[nb]
        end = torch.minimum(end, bound)
    jump = torch.cat([end, torch.tensor([m], device=dev)])
    starts = torch.zeros(1, dtype=torch.int64, device=dev)
    while True:
        new = jump[starts]
        new = new[new < m]
        if new.numel() == 0:
            return torch.sort(starts).values
        starts = torch.cat([starts, new])
        jump = jump[jump]


def _put_le(img: torch.Tensor, pos: torch.Tensor, value: torch.Tensor,
            nbytes: int) -> None:
    """Write ``value`` little-endian (``nbytes`` bytes) at ``pos``."""
    for k in range(nbytes):
        img[pos + k] = ((value >> (8 * k)) & 0xFF).to(torch.uint8)


def copy_records_torch(img: torch.Tensor, rec_start: torch.Tensor,
                       payload: torch.Tensor, offsets: torch.Tensor,
                       batch_bytes: int = 1 << 24) -> None:
    """Copy record i (``payload[offsets[i]:offsets[i+1]]``) into ``img`` at
    ``rec_start[i]``, a batch of records at a time."""
    m = rec_start.shape[0]
    dev = img.device
    a = 0
    while a < m:
        # records a..b-1 hold at most batch_bytes (at least one record)
        b = int(torch.searchsorted(offsets, offsets[a] + batch_bytes,
                                   right=True)) - 1
        b = min(max(b, a + 1), m)
        lens = offsets[a + 1:b + 1] - offsets[a:b]
        lo, hi = int(offsets[a]), int(offsets[b])
        if hi > lo:
            rec = torch.repeat_interleave(torch.arange(a, b, device=dev),
                                          lens)
            src = torch.arange(lo, hi, device=dev)
            img[rec_start[rec] + (src - offsets[rec])] = payload[src]
        a = b


def pack_blocks_torch(ids: torch.Tensor, lens: torch.Tensor,
                      implicit_ids: bool = False, fill_factor: float = 1.0,
                      breaks: torch.Tensor | None = None,
                      payload: torch.Tensor | None = None,
                      offsets: torch.Tensor | None = None) -> PackedBlocks:
    """:func:`pack_blocks` on tensors: id-ordered records of ``lens`` bytes
    -> the same :class:`PackedBlocks` (block image, ``rec_block``,
    ``rec_start``, ``rec_len``, ``block_first_id``), as tensors on
    ``lens.device``.

    The block headers are written; the records themselves are copied in
    only when ``payload`` (uint8) and ``offsets`` ([m+1]) are given.
    Otherwise their bytes stay zero and the caller encodes each record
    straight into ``data`` at ``rec_start`` (the stores do, so a shard's
    records never exist twice). ``breaks`` (sorted record indices) forces a
    block to start at each one: the vector store packs per chunk this way
    in one call, with the per-chunk packings' blocks and bytes.
    """
    dev = lens.device
    m = lens.shape[0]
    ids = ids.to(device=dev, dtype=torch.int64)
    lens = lens.to(torch.int64)
    per_rec = 2 if implicit_ids else _HDR_PER_REC
    hdr_fixed = (_HDR_FIXED + 4) if implicit_ids else _HDR_FIXED
    if m and bool((lens + hdr_fixed + per_rec > BLOCK_SIZE).any()):
        raise ValueError("record larger than a block")
    if not 0.0 < fill_factor <= 1.0:
        raise ValueError(f"fill_factor must be in (0, 1], got {fill_factor}")
    limit = int(BLOCK_SIZE * fill_factor)
    starts = _block_starts(per_rec + lens, limit - hdr_fixed, breaks)
    n_blocks = starts.shape[0]
    r = torch.arange(m, device=dev)
    rec_block = torch.searchsorted(starts, r, right=True) - 1
    bounds = torch.cat([starts, torch.tensor([m], device=dev)])
    count = bounds[1:] - bounds[:-1]
    cum = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=cum[1:])
    first = starts[rec_block]
    blk = rec_block * BLOCK_SIZE
    rec_start = (blk + hdr_fixed + count[rec_block] * per_rec
                 + cum[:-1] - cum[first])
    data = torch.zeros(n_blocks * BLOCK_SIZE, dtype=torch.uint8, device=dev)
    block_base = torch.arange(n_blocks, device=dev) * BLOCK_SIZE
    _put_le(data, block_base, count, 2)
    block_first_id = ids[starts]
    h = blk + hdr_fixed + (r - first) * per_rec
    if implicit_ids:
        _put_le(data, block_base + 2, block_first_id & 0xFFFFFFFF, 4)
        _put_le(data, h, rec_start - blk, 2)
    else:
        _put_le(data, h, ids & 0xFFFFFFFF, 4)
        _put_le(data, h + 4, rec_start - blk, 2)
    if payload is not None:
        copy_records_torch(data, rec_start, payload, offsets)
    return PackedBlocks(data=data, n_blocks=n_blocks,
                        rec_block=rec_block.to(torch.int32),
                        rec_start=rec_start, rec_len=lens.to(torch.int32),
                        block_first_id=block_first_id)


# ---------------------------------------------------------------------------
# Storage manifest (persisted output of the §3.2 compression planner)
# ---------------------------------------------------------------------------
# The planner (core/codec/registry.plan_components) samples each storage
# component — adjacency ids, EF slot streams, PQ codes, vector chunks —
# estimates every applicable codec, and persists the winners here. Stores
# build from the manifest; the search engine prices T_DEC from the resolved
# codec names instead of one hard-coded per-arm constant.

MANIFEST_VERSION = 1


@dataclass(frozen=True)
class ComponentPlan:
    """One component's resolved codec choice + the evidence behind it."""
    component: str
    codec: str                    # winning codec name (codec registry key)
    raw_bytes: int                # sample bytes before encoding
    est_bytes: int                # winning codec's estimated encoded bytes
    candidates: dict              # codec name -> estimated bytes (all tried)
    params: dict                  # codec context (e.g. universe, dtype)

    @property
    def ratio(self) -> float:
        return self.est_bytes / self.raw_bytes if self.raw_bytes else 1.0

    def to_json(self) -> dict:
        return dict(component=self.component, codec=self.codec,
                    raw_bytes=int(self.raw_bytes),
                    est_bytes=int(self.est_bytes),
                    candidates={k: int(v) for k, v in self.candidates.items()},
                    params=dict(self.params))

    @classmethod
    def from_json(cls, d: dict) -> "ComponentPlan":
        return cls(component=d["component"], codec=d["codec"],
                   raw_bytes=int(d["raw_bytes"]), est_bytes=int(d["est_bytes"]),
                   candidates=dict(d.get("candidates", {})),
                   params=dict(d.get("params", {})))


@dataclass(frozen=True)
class StorageManifest:
    """Per-component codec selection, persisted alongside the stores.

    The single source of truth that makes the three stores component-aware:
    ``codec_for()`` answers both build time (which codec encodes component
    X) and model time (what does decoding component X cost, see
    ``engine.CODEC_DEC_US``)."""
    components: dict            # component name -> ComponentPlan
    block_size: int = BLOCK_SIZE
    version: int = MANIFEST_VERSION
    #: Seal-time graph ordering the adjacency component was planned under
    #: ("bfs" / "bisection" / None = external-id layout). Stores built
    #: from_manifest must reproduce it or the plan's gap statistics (and
    #: the codec choice priced from them) no longer describe the data.
    reorder: str | None = None

    def codec_for(self, component: str, default: str = "raw") -> str:
        plan = self.components.get(component)
        return plan.codec if plan is not None else default

    def params_for(self, component: str) -> dict:
        plan = self.components.get(component)
        return dict(plan.params) if plan is not None else {}

    @property
    def total_ratio(self) -> float:
        raw = sum(p.raw_bytes for p in self.components.values())
        est = sum(p.est_bytes for p in self.components.values())
        return est / raw if raw else 1.0

    def to_json(self) -> dict:
        return dict(version=self.version, block_size=self.block_size,
                    reorder=self.reorder,
                    components={k: p.to_json()
                                for k, p in self.components.items()})

    @classmethod
    def from_json(cls, d: dict) -> "StorageManifest":
        return cls(components={k: ComponentPlan.from_json(p)
                               for k, p in d.get("components", {}).items()},
                   block_size=int(d.get("block_size", BLOCK_SIZE)),
                   version=int(d.get("version", MANIFEST_VERSION)),
                   reorder=d.get("reorder"))

    def save(self, path) -> None:
        import json
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    @classmethod
    def load(cls, path) -> "StorageManifest":
        import json
        with open(path) as f:
            return cls.from_json(json.load(f))
