"""Port parity tier for the kernels of the search path: each plain PyTorch
version in ``repro_torch.kernels`` against the JAX reference's ``ref``
oracle and its ``pallas-interpret`` kernel, on the sweeps of
tests/test_kernel_conformance.py, and the dispatch rules. The kernels
against their plain versions on the card are in tests/test_torch_cuda.py,
which also holds the seeded case makers used here.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: bit-exact wherever both sides fold in the same order (ADC over
m, EF decode, byteplane's XOR, the fused hop's ids and top_idx, rerank at
D <= 32); the Pallas kernels compute ADC and rerank as matmuls, so against
``pallas-interpret`` distances are held to the conformance tier's own
tolerances; jnp's rerank sum at D = 128 is no left fold, so there rtol is
1e-6.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core.graph.pq import PQCodebook, encode_pq
from repro.kernels import dispatch as jdispatch
from repro.kernels.byteplane.byteplane import byteplane_decode_pallas
from repro.kernels.byteplane.ref import byteplane_decode_ref as jbyteplane
from repro.kernels.pq_adc.pq_adc import pq_adc_batched_pallas, pq_adc_pallas
from repro.kernels.pq_adc.ref import pq_adc_ref as jpq_adc
from repro.kernels.rerank_l2.ref import rerank_l2_ref as jrerank_l2
from repro.kernels.dispatch import KernelConfig as JKernelConfig

from repro_torch.kernels import dispatch
from repro_torch.kernels.beam_step.beam_step import (beam_step_cuda,
                                                     beam_step_ref)
from repro_torch.kernels.byteplane.byteplane import (byteplane_decode_cuda,
                                                     byteplane_decode_ref)
from repro_torch.kernels.dispatch import get_impl
from repro_torch.kernels.ef_decode.ef_decode import (ef_decode_cuda,
                                                     ef_decode_ref)
from repro_torch.kernels.pq_adc.pq_adc import (pq_adc_batched_cuda,
                                               pq_adc_batched_ref,
                                               pq_adc_cuda, pq_adc_ref)
from repro_torch.kernels.pq_encode.pq_encode import (pq_encode_cuda,
                                                     pq_encode_ref)
from repro_torch.kernels.rerank_l2.rerank_l2 import (rerank_l2_cuda,
                                                     rerank_l2_ref)
from repro_torch.kernels.rerank_loop.rerank_loop import rerank_loop_cuda

from test_torch_cuda import (ADC_ID_CASES, BEAM_CASES, BYTEPLANE_SHAPES,
                             RERANK_ID_CASES, adc_case, adc_ids_case,
                             assert_bits_equal, beam_case, byteplane_case,
                             ef_ids, ef_slots, huffman_case, rerank_ids_case,
                             rerank_loop_case, single_adc_case)

JREF = JKernelConfig("ref", "ref", "ref", "ref", "ref")
JPAL = JKernelConfig(*(["pallas-interpret"] * 5))
T = torch.from_numpy


# ------------------------------------------------------------------ pq_adc
@pytest.mark.parametrize("m", [8, 16, 32])
@pytest.mark.parametrize("nq,n", [(1, 1), (3, 130), (8, 96)])
def test_pq_adc_batched_matches_reference(nq, n, m):
    codes, luts = adc_case(nq, n, m, seed=nq * 100 + n + m)
    got = pq_adc_batched_ref(T(codes), T(luts))
    want = jdispatch.pq_adc_batched(jnp.asarray(codes), jnp.asarray(luts),
                                    JREF)
    assert_bits_equal(got, want)
    pal = jdispatch.pq_adc_batched(jnp.asarray(codes), jnp.asarray(luts),
                                   JPAL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("case", sorted(ADC_ID_CASES))
def test_pq_adc_batched_by_id_through_dispatch(case):
    """dispatch.pq_adc_batched on CPU tensors with ids == the reference on
    ``codes[clip(ids)]``, masked to +inf where ids < 0: bit for bit against
    its ``ref``, within the conformance tolerance against the Pallas
    kernel (a one-hot matmul) in interpret mode."""
    table, luts, ids = adc_ids_case(**ADC_ID_CASES[case])
    got = dispatch.pq_adc_batched(T(table), T(luts), ids=T(ids))
    assert got.shape == ids.shape
    rows = jnp.asarray(table[np.clip(ids, 0, len(table) - 1)])
    mask = jnp.asarray(ids) >= 0
    want = jnp.where(mask, jdispatch.pq_adc_batched(rows, jnp.asarray(luts),
                                                    JREF), jnp.inf)
    assert_bits_equal(got, want)
    if ids.size:    # the Pallas grid needs a row block
        pal = jnp.where(mask, pq_adc_batched_pallas(
            rows, jnp.asarray(luts), interpret=True), jnp.inf)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=1e-6,
                                   atol=1e-5)
    assert np.isinf(got.numpy()[ids < 0]).all()


def test_pq_adc_batched_all_equal_codes():
    codes, luts = adc_case(2, 130, 32, seed=5, equal_codes=True)
    got = pq_adc_batched_ref(T(codes), T(luts)).numpy()
    assert all(len(set(row.tolist())) == 1 for row in got)
    assert_bits_equal(got, jdispatch.pq_adc_batched(
        jnp.asarray(codes), jnp.asarray(luts), JREF))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("n,m,k", [
    *(pytest.param(n, m, 256, id=f"{n}-{m}")
      for n, m in [(1, 8), (1024, 8), (4096, 8), (300, 32), (7, 1)]),
    *(pytest.param(n, m, k, id=f"{n}-{m}-k{k}")
      for n, m, k in [(300, 64, 256), (257, 64, 16), (255, 32, 16),
                      (31, 12, 16), (4099, 7, 16)])])
def test_pq_adc_matches_reference(n, m, k, dtype):
    """Bit for bit against the reference's oracle up to M = 32, where
    jnp's sum is a left fold; at M = 64 XLA sums in another order, so there
    the conformance tolerance holds, as against the Pallas kernel."""
    codes, lut = single_adc_case(n, m, seed=n + m, dtype=dtype, k=k)
    got = pq_adc_ref(T(codes), T(lut))
    want = jpq_adc(jnp.asarray(codes), jnp.asarray(lut))
    if m <= 32:
        assert_bits_equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-5)
    assert_bits_equal(dispatch.pq_adc(T(codes), T(lut)), got)
    pal = pq_adc_pallas(jnp.asarray(codes), jnp.asarray(lut), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=1e-6,
                               atol=1e-5)


def test_pq_adc_all_equal_codes():
    codes, lut = single_adc_case(129, 32, seed=5, fill=3)
    got = pq_adc_ref(T(codes), T(lut)).numpy()
    assert len(set(got.tolist())) == 1
    assert_bits_equal(got, jpq_adc(jnp.asarray(codes), jnp.asarray(lut)))


# --------------------------------------------------------------- byteplane
@pytest.mark.parametrize("n,v", BYTEPLANE_SHAPES)
def test_byteplane_matches_reference(n, v):
    packed, base = byteplane_case(n, v, seed=n + v)
    got = byteplane_decode_ref(T(packed), T(base))
    assert_bits_equal(got, jbyteplane(jnp.asarray(packed), jnp.asarray(base)))
    assert_bits_equal(dispatch.byteplane_decode(T(packed), T(base)), got)
    if n:    # the Pallas grid needs a row block
        assert_bits_equal(got, byteplane_decode_pallas(
            jnp.asarray(packed), jnp.asarray(base), interpret=True))
    assert_bits_equal(byteplane_decode_ref(got, T(base)), packed)


# --------------------------------------------------------------- ef_decode
@pytest.mark.parametrize("r_max,universe",
                         [(8, 64), (16, 1000), (24, 1200), (24, 10**5),
                          (32, 10**6), (128, 31_250_000)])
def test_ef_decode_matches_reference(r_max, universe):
    """Every row in order (``ids=None``) and rows by id (both edges,
    repeats, ids past either end) equal the reference on the table and on
    ``slots[clip(ids)]``."""
    slots, truth = ef_slots(r_max, universe, seed=r_max)
    nb, ct = ef_decode_ref(T(slots.view(np.int32)), r_max, universe)
    ids = ef_ids(len(slots))
    nb_i, ct_i = ef_decode_ref(T(slots.view(np.int32)), r_max, universe,
                               T(ids))
    picked = slots[np.clip(ids, 0, len(slots) - 1)]
    for cfg in (JREF, JPAL):
        nb_j, ct_j = jdispatch.ef_decode(jnp.asarray(slots), r_max,
                                         universe, cfg)
        assert_bits_equal(nb, nb_j)
        assert_bits_equal(ct, ct_j)
        nb_j, ct_j = jdispatch.ef_decode(jnp.asarray(picked), r_max,
                                         universe, cfg)
        assert_bits_equal(nb_i, nb_j)
        assert_bits_equal(ct_i, ct_j)
    for i, vals in enumerate(truth):
        assert int(ct[i]) == len(vals)
        np.testing.assert_array_equal(nb[i, :len(vals)].numpy(),
                                      vals.astype(np.int64))
        assert (nb[i, len(vals):] == universe - 1).all()


@pytest.mark.parametrize("ids", ["none", "edges", "repeated", "one",
                                 "empty"])
def test_ef_decode_by_id_through_dispatch(ids):
    """dispatch.ef_decode on CPU tensors: rows by id == the reference's
    decode of the clipped gather; no ids == every row in order."""
    slots, _ = ef_slots(24, 1200, seed=5)
    rows = {"none": None, "edges": ef_ids(len(slots)),
            "repeated": np.array([3, 3, 3, 0, 0], dtype=np.int32),
            "one": np.array([len(slots) - 1], dtype=np.int32),
            "empty": np.zeros(0, dtype=np.int32)}[ids]
    got = dispatch.ef_decode(T(slots.view(np.int32)), 24, 1200,
                             ids=None if rows is None else T(rows))
    picked = slots if rows is None else slots[np.clip(rows, 0,
                                                      len(slots) - 1)]
    want = jdispatch.ef_decode(jnp.asarray(picked), 24, 1200, JREF)
    assert got[0].shape == (len(picked), 24)
    for g, w in zip(got, want):
        assert_bits_equal(g, w)


def test_ef_decode_malformed_slots_match_reference():
    """Bitmaps with fewer set bits than r_max (all-zero slots, a slot cut
    short) decode exactly as the reference's argmax select does."""
    slots, _ = ef_slots(24, 1200, seed=3)
    slots = np.concatenate([slots, np.zeros_like(slots[:2])])
    slots[-3, -1] = 0
    nb, ct = ef_decode_ref(T(slots.view(np.int32)), 24, 1200)
    nb_j, ct_j = jdispatch.ef_decode(jnp.asarray(slots), 24, 1200, JREF)
    assert_bits_equal(nb, nb_j)
    assert_bits_equal(ct, ct_j)


# --------------------------------------------------------------- beam_step
@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_step_matches_reference(case):
    """The plain version reads the code rows of new_ids from the table:
    it equals the reference's beam_step on ``pq_codes[clip(new_ids)]``."""
    args = beam_case(**BEAM_CASES[case])
    pq_codes, new_ids = args[0], args[4]
    gathered = (pq_codes[np.clip(new_ids, 0, len(pq_codes) - 1)],
                *args[1:])
    ids, d, ix = beam_step_ref(*map(T, args))
    ids_r, d_r, ix_r = jdispatch.beam_step(*map(jnp.asarray, gathered),
                                           JREF)
    assert_bits_equal(ids, ids_r)
    assert_bits_equal(ix, ix_r)
    assert_bits_equal(d, d_r)
    ids_p, d_p, ix_p = jdispatch.beam_step(*map(jnp.asarray, gathered),
                                           JPAL)
    assert_bits_equal(ids, ids_p)
    assert_bits_equal(ix, ix_p)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_p), rtol=1e-5,
                               atol=1e-4)
    if case == "all-masked":
        assert_bits_equal(ids, args[2])
        np.testing.assert_array_equal(ix.numpy(), np.tile(np.arange(8),
                                                          (3, 1)))


@pytest.mark.parametrize("m", [8, 384])
def test_beam_step_matches_unfused_composition(m):
    """The fused op == pq_adc_batched + mask + concat + stable top-L, the
    reference's unfused hop, at the small world's M and at a wide code's
    (M = 384, a LUT in 12 slices on the card)."""
    pq_codes, luts, cand_ids, cand_d, new_ids = map(T, beam_case(
        5, 33, 20, m, seed=23))
    codes = pq_codes[new_ids.clamp(0, len(pq_codes) - 1)]
    d = torch.where(new_ids >= 0, pq_adc_batched_ref(codes, luts), torch.inf)
    merged_d = torch.cat([cand_d, d], 1)
    order = torch.sort(merged_d, dim=1, stable=True).indices[:, :20]
    ids, got_d, ix = beam_step_ref(pq_codes, luts, cand_ids, cand_d,
                                   new_ids)
    assert_bits_equal(ix, order.to(torch.int32))
    assert_bits_equal(ids, torch.gather(torch.cat([cand_ids, new_ids], 1), 1,
                                        order))
    assert_bits_equal(got_d, torch.gather(merged_d, 1, order))


def _left_fold_adc(codes, luts):
    """[nq, n, M] codes x [nq, M, K] LUTs, m folded in order in float32."""
    nq, n, m = codes.shape
    rows = np.arange(nq)[:, None]
    acc = luts[rows, 0, codes[..., 0]]
    for j in range(1, m):
        acc = (acc + luts[rows, j, codes[..., j]]).astype(np.float32)
    return acc


@pytest.mark.parametrize("m", [384, 385])
def test_pq_adc_batched_plain_wide_codes_are_a_left_fold(m):
    """At M = 384 (and a ragged 385) the plain version folds m in order,
    by id (+inf where masked) and on gathered rows; jnp's sum is no left
    fold at this width, so the fold is written out here."""
    table, luts, ids = adc_ids_case(4, 40, m, seed=m)
    rows = table[np.clip(ids, 0, len(table) - 1)]
    want = np.where(ids >= 0, _left_fold_adc(rows, luts), np.inf)
    assert_bits_equal(pq_adc_batched_ref(T(table), T(luts), T(ids)),
                      want.astype(np.float32))
    assert_bits_equal(pq_adc_batched_ref(T(rows), T(luts)),
                      _left_fold_adc(rows, luts))


# --------------------------------------------------------------- rerank_l2
@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("q,c,d", [(1, 1, 8), (7, 20, 32), (32, 10, 32),
                                   (9, 130, 128), (3, 5, 128)])
def test_rerank_l2_matches_reference(q, c, d, dtype):
    rng = np.random.default_rng(q * c + d)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    if dtype == "u8":
        queries *= 20
        cands = rng.integers(0, 256, (q, c, d), dtype=np.uint8)
    else:
        cands = rng.normal(size=(q, c, d)).astype(np.float32)
    got = rerank_l2_ref(T(queries), T(cands))
    want = jdispatch.rerank_l2(jnp.asarray(queries), jnp.asarray(cands), JREF)
    if d <= 32:
        assert_bits_equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    pal = jdispatch.rerank_l2(jnp.asarray(queries), jnp.asarray(cands), JPAL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("case", sorted(RERANK_ID_CASES))
def test_rerank_l2_by_id_through_dispatch(case, dtype):
    """dispatch.rerank_l2 on CPU tensors with ids == the reference oracle
    on ``table[clip(ids, 0, N - 1)]`` (nothing masked): bit for bit at
    D <= 32, rtol 1e-6 above (jnp's sum is no left fold there)."""
    queries, table, ids = rerank_ids_case(
        dtype=np.uint8 if dtype == "u8" else np.float32,
        **RERANK_ID_CASES[case])
    got = dispatch.rerank_l2(T(queries), T(table), ids=T(ids))
    assert got.shape == ids.shape
    rows = table[np.clip(ids, 0, len(table) - 1)]
    want = jrerank_l2(jnp.asarray(queries), jnp.asarray(rows))
    if queries.shape[1] <= 32:
        assert_bits_equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert_bits_equal(got, rerank_l2_ref(T(queries), T(rows)))


def test_rerank_l2_equal_rows_are_zero():
    q = np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32)
    cands = np.repeat(q[:, None, :], 9, axis=1)
    assert (rerank_l2_ref(T(q), T(cands)) == 0).all()


# --------------------------------------------------------------- pq_encode
@pytest.mark.parametrize("n,d,m,dtype", [
    (600, 32, 8, np.float32), (300, 128, 32, np.uint8),
    (50, 8, 8, np.float32),
    # dsub 3 (DEEP1B's M = 32 over D = 96), 5 and 6: the generic widths
    *[(n, d, m, t) for n, d, m in [(310, 96, 32), (320, 20, 4),
                                   (330, 24, 4)]
      for t in (np.float32, np.uint8)]])
def test_pq_encode_plain_matches_numpy_encoder(n, d, m, dtype):
    """The plain version of the on-card encoder gives the reference's
    numpy codes byte for byte, duplicated centroids (ties) included, at
    the templated widths and at dsub 3, 5 and 6."""
    rng = np.random.default_rng(n + d)
    x = (rng.integers(0, 40, (n, d)) if dtype == np.uint8
         else rng.normal(size=(n, d))).astype(dtype)
    cents = (rng.normal(size=(m, 256, d // m)) * 10).astype(np.float32)
    cents[:, 200:] = cents[:, :56]
    want = encode_pq(x, PQCodebook(centroids=cents, dim=d))
    np.testing.assert_array_equal(pq_encode_ref(T(x), T(cents)).numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_pq_encode_plain_folds_wide_dsub_in_order(dtype):
    """At dsub 24, where numpy's sum is no left fold, the plain version's
    codes are the first centroid at least distance, the distance a left
    fold over dsub in float32, duplicated centroids (ties) included."""
    dsub = 24
    rng = np.random.default_rng(dsub)
    m, n = 4, 300
    x = (rng.integers(0, 40, (n, m * dsub)) if dtype == np.uint8
         else rng.normal(size=(n, m * dsub))).astype(dtype)
    cents = (rng.normal(size=(m, 256, dsub)) * 10).astype(np.float32)
    cents[:, 200:] = cents[:, :56]
    xs = x.astype(np.float32).reshape(n, m, 1, dsub)
    sq = (xs - cents[None]) ** 2                             # [n, m, K, ds]
    acc = sq[..., 0]
    for s_ in range(1, dsub):
        acc = (acc + sq[..., s_]).astype(np.float32)
    np.testing.assert_array_equal(pq_encode_ref(T(x), T(cents)).numpy(),
                                  acc.argmin(-1).astype(np.uint8))


@pytest.mark.parametrize("d,m,k,ok", [(96, 32, 256, True),
                                       (768, 384, 256, True),
                                       (904, 8, 256, True),
                                       (912, 8, 256, True),
                                       (8, 16, 256, False),
                                       (96, 32, 257, False),
                                       (96, 31, 256, False)])
def test_pq_encode_wrapper_takes_any_dsub(d, m, k, ok):
    """The kernel's wrapper takes any dsub >= 1 with K <= 256 and
    D = M * dsub, and refuses the rest before it looks for a card (whether
    the centroids fit a block's shared memory is the card's to say)."""
    x = torch.zeros(3, d)
    cents = torch.zeros(m, k, d // m)
    with pytest.raises(ValueError, match="CUDA" if ok else "dsub"):
        pq_encode_cuda(x, cents)


# ---------------------------------------------------------- dispatch layer
def _op_args(op):
    """Small CPU inputs of each registered op."""
    from repro_torch.core.codec import elias_fano as ef
    if op == "pq_adc":
        return tuple(map(T, single_adc_case(40, 8, seed=1)))
    if op == "pq_adc_batched":
        return tuple(map(T, adc_ids_case(3, 20, 8, seed=2)))
    if op == "ef_decode":
        slots, _ = ef_slots(24, 1200, seed=3)
        return T(slots.view(np.int32)), 24, 1200, T(ef_ids(len(slots)))
    if op == "ef_record_decode":
        nbrs = T(np.sort(np.random.default_rng(4).integers(0, 5000, (6, 9)),
                         axis=1))
        payload, offsets = ef.encode_records_torch(
            *ef.sort_lists_torch(nbrs), 5000)
        return (payload, offsets[:-1].contiguous(),
                (offsets[1:] - offsets[:-1]).to(torch.int32),
                torch.tensor([5, 0, 2, 9, -1]))
    if op == "rerank_l2":
        return tuple(map(T, rerank_ids_case(3, 10, 32, seed=5)))
    if op == "rerank_loop":
        q, table, cand, tomb = map(T, rerank_loop_case(5, 16, 40, seed=9))
        return q, table, cand, 10, 10, 3, 0.1, tomb
    if op == "byteplane":
        return tuple(map(T, byteplane_case(7, 16, seed=6)))
    if op == "huffman_decode":
        payload, starts, table, bases, base_of, _ = huffman_case("skewed", 16)
        return T(payload), T(starts), 16, table, T(bases), T(base_of)
    if op == "beam_step":
        return tuple(map(T, beam_case(3, 20, 16, 8, seed=7)))
    if op == "pq_encode":
        rng = np.random.default_rng(8)
        return (T(rng.normal(size=(11, 32)).astype(np.float32)),
                T(rng.normal(size=(8, 16, 4)).astype(np.float32)))
    raise KeyError(op)


PUBLIC_OP = {"byteplane": "byteplane_decode"}


@pytest.mark.parametrize("op", sorted({op for op, _ in dispatch._registry()}))
def test_every_op_follows_the_tensors_device(op):
    """The public op on CPU tensors is its plain version, bit for bit; on a
    device without a backend (meta) it raises. No other argument picks an
    implementation."""
    args = _op_args(op)
    public = getattr(dispatch, PUBLIC_OP.get(op, op))
    got, want = public(*args), get_impl(op, "ref")(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_bits_equal(a, b)
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(ValueError, match="no kernel backend"):
        public(*meta)


def test_backend_follows_the_tensors_device():
    assert dispatch.resolve_backend(torch.device("cpu")) == "ref"
    assert dispatch.resolve_backend(torch.device("cuda")) == "cuda"
    codes, luts = adc_case(2, 5, 8, seed=0)
    assert_bits_equal(dispatch.pq_adc_batched(T(codes), T(luts)),
                      pq_adc_batched_ref(T(codes), T(luts)))
    with pytest.raises(ValueError, match="no kernel backend"):
        dispatch.resolve_backend(torch.device("meta"))


def test_dispatch_refuses_unknown_and_unresolved_backends():
    """The registry has the two backends of the device rule and nothing a
    request could name: no per-op request, no ``auto`` or ``off``."""
    assert {b for _, b in dispatch._registry()} == set(dispatch.BACKENDS) \
        == {"ref", "cuda"}
    assert not [n for n in vars(dispatch) if n.endswith("Config")
                or n in ("REQUESTED", "default_config")]
    for backend in ("auto", "off", "auto-tuned", "pallas"):
        with pytest.raises(KeyError):
            get_impl("pq_adc_batched", backend)
    with pytest.raises(KeyError):
        get_impl("no_such_op", "cuda")
    codes, luts = adc_case(2, 5, 8, seed=0)
    with pytest.raises(TypeError):
        dispatch.pq_adc_batched(T(codes), T(luts), None, None)


def test_kernel_build_needs_nvcc(tmp_path, monkeypatch):
    """Each kernel library is named by a hash of its source and built at
    first use; without the CUDA toolkit the build raises (nothing falls
    back to the plain versions)."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    for name in build.SOURCES:
        path = build.library_path(name)
        assert path.parent == tmp_path / "kernels"
        assert path.name.startswith(name + "-") and path.suffix == ".so"
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    assert not (tmp_path / "kernels").exists() or not any(
        (tmp_path / "kernels").iterdir())


def test_rerank_loop_wrapper_refuses_what_it_does_not_take():
    """The one-launch re-rank takes int32 ids, uint8 or float32 rows,
    float32 queries of the rows' width, an [N] bool mask and counts >= 0;
    each refusal comes before any launch."""
    q, table, cand, tomb = map(T, rerank_loop_case(3, 8, 30, seed=1))
    args = (10, 10, 2, 0.1)
    with pytest.raises(TypeError, match="int32 candidate ids"):
        rerank_loop_cuda(q, table, cand.long(), *args)
    with pytest.raises(TypeError, match="uint8 or float32 vectors"):
        rerank_loop_cuda(q, table.double(), cand, *args)
    with pytest.raises(ValueError, match="float32 queries"):
        rerank_loop_cuda(q.double(), table, cand, *args)
    with pytest.raises(ValueError, match="float32 queries"):
        rerank_loop_cuda(q[:, :4], table, cand, *args)
    with pytest.raises(ValueError, match="bool tombstone"):
        rerank_loop_cuda(q, table, cand, *args, tomb[:-1])
    with pytest.raises(ValueError, match="bool tombstone"):
        rerank_loop_cuda(q, table, cand, *args, tomb.to(torch.uint8))
    with pytest.raises(ValueError, match=">= 0"):
        rerank_loop_cuda(q, table, cand, 10, 10, -1, 0.1)
    with pytest.raises(ValueError, match="empty table"):
        rerank_loop_cuda(q, table[:0], cand, *args)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor a kernel wrapper raises; only dispatch picks the
    plain version, and only because the tensors are on the CPU."""
    codes, luts = adc_case(2, 5, 8, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        pq_adc_batched_cuda(T(codes), T(luts))
    with pytest.raises(ValueError, match="CUDA"):
        pq_adc_batched_cuda(*map(T, adc_ids_case(2, 5, 8, seed=0)))
    with pytest.raises(ValueError, match="CUDA"):
        rerank_l2_cuda(T(luts[:, 0]), T(luts))
    with pytest.raises(ValueError, match="CUDA"):
        rerank_l2_cuda(*map(T, rerank_ids_case(2, 5, 8, seed=0)))
    q, table, cand, tomb = map(T, rerank_loop_case(2, 8, 30, seed=0))
    for mask in (None, tomb):
        with pytest.raises(ValueError, match="CUDA"):
            rerank_loop_cuda(q, table, cand, 10, 10, 2, 0.1, mask)
    with pytest.raises(ValueError, match="CUDA"):
        pq_adc_cuda(T(codes[0]), T(luts[0]))
    packed, base = byteplane_case(4, 8, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        byteplane_decode_cuda(T(packed), T(base))
    with pytest.raises(ValueError, match="CUDA"):
        beam_step_cuda(*map(T, beam_case(2, 5, 4, 8, seed=0)))
    slots, _ = ef_slots(8, 64, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        ef_decode_cuda(T(slots.view(np.int32)), 8, 64, T(ef_ids(6)))
