"""CPU parity of the port's LM serving path (``repro_torch.serve.engine``,
``repro_torch.serve.rag``, ``repro_torch.launch.serve``) with the JAX
reference, and the two reference faults the port does not carry over.

- ``ServeEngine.generate`` at temperature 0 against the reference's
  ``prefill`` + ``decode_step`` driven over a cache the test widens with
  numpy (tests/torch_lm_parity.py): tokens identical, except that where the
  reference's best two logits lie within ``TIE_ATOL`` (1e-4) either token
  is accepted and the margin reported.
- RAG retrieval ids and I/O stats identical to the reference's pipeline on
  the same params and documents; generated tokens as above.
- The reference's decode into a prefill cache of exactly S slots
  overwrites token 0 (``repro/serve/engine.py``, ``models/transformer.py``)
  and its encoder-decoder prefill leaves the self-K/V zero
  (``models/api.py``): both pinned on the reference, and the port's
  decode held to a prefill (or ``decode_train``) over S + 1 tokens.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import ARCHS, get_config, reduce_config
from repro.core.search.engine import EngineConfig as JEngineConfig
from repro.core.search.engine import search_decoupled
from repro.core.storage.index_store import CompressedIndexStore as JIS
from repro.core.storage.vector_store import DecoupledVectorStore as JVS
from repro.core.storage.vector_store import StoreConfig as JSC
from repro.data.synthetic import make_token_batch
from repro.models import encdec as jencdec
from repro.models.api import Model as JModel
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.rag import RAGPipeline as JRAGPipeline

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_config as t_reduce_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import encdec as tencdec
from repro_torch.models.api import Model
from repro_torch.models.schema import params_from_numpy
from repro_torch.serve.engine import ServeEngine, widen_cache
from repro_torch.serve.rag import RAGPipeline, embed_tokens

from torch_lm_parity import (B, ENC_FRAMES, MAX_NEW, S, TIE_ATOL, arch_batch,
                             as_jax, as_torch, reference,
                             reference_greedy, widen_np)

#: Logit tolerance of a float32 decode against a float32 prefill of the
#: same sequence: the two sum in different orders (one query row against
#: a masked cache vs the full causal block).
DECODE_ATOL = 1e-4

DECODER_ONLY = sorted(a for a in ARCHS if a != "seamless-m4t-medium")


def port_engine(ref):
    return ServeEngine(ref.tm, ref.tp, device="cpu")


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_generate_matches_widened_reference(arch):
    ref = reference(arch)
    batch = arch_batch(ref.jm.cfg, seed=1)
    gen = port_engine(ref).generate(batch["tokens"], max_new=MAX_NEW,
                                    frontend=batch.get("frontend"))
    assert gen.shape == (B, MAX_NEW) and gen.dtype == np.int32
    reference_greedy(ref, batch, gen)


def test_encdec_generate_is_greedy_decode_train():
    """seamless-m4t-medium: each generated token is the argmax of the
    port's ``decode_train`` over the prompt and the tokens before it; that
    ``decode_train`` equals the reference's on the whole sequence."""
    ref = reference("seamless-m4t-medium")
    cfg = ref.jm.cfg
    batch = arch_batch(cfg, seed=1)
    gen = port_engine(ref).generate(batch["tokens"], max_new=MAX_NEW,
                                    frontend=batch["frames"])
    frames = torch.from_numpy(batch["frames"])
    with torch.no_grad():
        memory = tencdec.encode(ref.tp, ref.tm.cfg, frames, "dense")
        for i in range(MAX_NEW):
            seq = np.concatenate([batch["tokens"], gen[:, :i]], 1)
            logits = tencdec.decode_train(ref.tp, ref.tm.cfg, memory,
                                          torch.from_numpy(seq).long(),
                                          "dense")[:, -1].numpy()
            best = logits.argmax(-1)
            for r in range(B):
                margin = logits[r, best[r]] - logits[r, gen[r, i]]
                assert margin <= TIE_ATOL, (i, r, margin)
        full = np.concatenate([batch["tokens"], gen], 1)
        got = tencdec.decode_train(ref.tp, ref.tm.cfg, memory,
                                   torch.from_numpy(full).long(), "dense")
    jmem = jencdec.encode(ref.jp, cfg, jnp.asarray(batch["frames"]), "dense")
    want = jencdec.decode_train(ref.jp, cfg, jmem, jnp.asarray(full),
                                "dense")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=DECODE_ATOL)


def test_temperature_sampling_is_seeded():
    ref = reference("internlm2-1.8b")
    toks = arch_batch(ref.jm.cfg)["tokens"]
    runs = [ServeEngine(ref.tm, ref.tp, temperature=1.0, seed=s,
                        device="cpu").generate(toks, max_new=8)
            for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert ((runs[0] >= 0) & (runs[0] < ref.jm.cfg.vocab)).all()


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "pixtral-12b",
                                  "seamless-m4t-medium"])
def test_greedy_margins(arch):
    """``greedy_margins`` (the near-tie rule's measure) of the engine's own
    greedy tokens are all 0; with step 0's token swapped for the prefill's
    worst, step 0's margin is that prefill's spread (max - min logit) and
    no margin is negative. Covers the vision frontend and the frames."""
    ref = reference(arch)
    batch = arch_batch(ref.jm.cfg, seed=1)
    front = batch.get("frames", batch.get("frontend"))
    eng = port_engine(ref)
    gen = eng.generate(batch["tokens"], max_new=MAX_NEW, frontend=front)
    margins = eng.greedy_margins(batch["tokens"], gen, front)
    assert margins.shape == (MAX_NEW, B) and not margins.any()
    with torch.no_grad():
        logits, _ = ref.tm.prefill(ref.tp, as_torch(batch),
                                   attn_mode="dense")
    last = logits[:, -1].float().numpy()
    swapped = gen.copy()
    swapped[:, 0] = last.argmin(-1)
    margins = eng.greedy_margins(batch["tokens"], swapped, front)
    np.testing.assert_allclose(margins[0], last.max(-1) - last.min(-1),
                               rtol=1e-6)
    assert (margins >= 0).all()


# ------------------------------------------------------------ the two faults
def test_decode_extends_the_prefill_and_the_reference_does_not():
    """internlm2 reduced, seed 0: decoding token S after a prefill of S
    equals the last logits of a prefill over S + 1 tokens on the port; the
    reference's decode (a cache of S slots, token 0 overwritten) does not."""
    ref = reference("internlm2-1.8b")
    batch = arch_batch(ref.jm.cfg)
    nxt = make_token_batch(ref.jm.cfg.vocab, B, 1, seed=9)
    longer = {"tokens": np.concatenate([batch["tokens"], nxt], 1)}
    pos = np.full((B,), S, np.int32)
    _, jc = ref.prefill(ref.jp, as_jax(batch))
    j_dec, _ = ref.decode(ref.jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
    j_long, _ = jax.jit(lambda p, b: ref.jm.prefill(p, b, attn_mode="dense"))(
        ref.jp, as_jax(longer))
    gap = np.abs(np.asarray(j_dec) - np.asarray(j_long)).max()
    assert gap > 1e-2, f"the reference's decode now extends its prefill ({gap})"
    with torch.no_grad():
        _, tc = ref.tm.prefill(ref.tp, as_torch(batch), attn_mode="dense")
        tc = widen_cache(ref.tm, tc, B, S + 1)
        t_dec, _ = ref.tm.decode_step(ref.tp, tc, torch.from_numpy(nxt).long(),
                                      torch.from_numpy(pos).long())
        t_long, _ = ref.tm.prefill(ref.tp, as_torch(longer),
                                   attn_mode="dense")
    np.testing.assert_allclose(t_dec.numpy(), t_long.numpy(), rtol=0,
                               atol=DECODE_ATOL)
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_long), rtol=0,
                               atol=DECODE_ATOL)


def test_encdec_prefill_fills_the_self_kv_and_the_reference_does_not():
    """seamless-m4t reduced, seed 0: the reference's prefill returns an
    all-zero self-K/V cache and its first decode differs from
    ``decode_train`` over S + 1 tokens; the port's prefill holds the
    prompt's K/V and its decode agrees."""
    ref = reference("seamless-m4t-medium")
    cfg = ref.jm.cfg
    batch = arch_batch(cfg)
    nxt = make_token_batch(cfg.vocab, B, 1, seed=9)
    full = np.concatenate([batch["tokens"], nxt], 1)
    pos = np.full((B,), S, np.int32)
    _, jc = ref.prefill(ref.jp, as_jax(batch))
    assert not np.asarray(jc["k"]).any() and not np.asarray(jc["v"]).any()
    jmem = jencdec.encode(ref.jp, cfg, jnp.asarray(batch["frames"]), "dense")
    want = np.asarray(jencdec.decode_train(ref.jp, cfg, jmem,
                                           jnp.asarray(full), "dense"))[:, -1]
    jcache = widen_np(ref.jm, jc, B, S + 1, ENC_FRAMES)
    j_dec, _ = ref.decode(ref.jp, jcache, jnp.asarray(nxt), jnp.asarray(pos))
    gap = np.abs(np.asarray(j_dec)[:, 0] - want).max()
    assert gap > 1.0, f"the reference's encdec decode now agrees ({gap})"
    with torch.no_grad():
        _, tc = ref.tm.prefill(ref.tp, as_torch(batch), attn_mode="dense")
        assert tc["k"].abs().amax(dim=(0, 1, 3, 4)).gt(0).all()
        tc = widen_cache(ref.tm, tc, B, S + 1, ENC_FRAMES)
        t_dec, _ = ref.tm.decode_step(ref.tp, tc, torch.from_numpy(nxt).long(),
                                      torch.from_numpy(pos).long())
    np.testing.assert_allclose(t_dec[:, 0].numpy(), want, rtol=0,
                               atol=DECODE_ATOL)


# ---------------------------------------------------------------------- RAG
N_DOCS = 256


@pytest.fixture(scope="module")
def rag_docs():
    ref = reference("internlm2-1.8b")
    return ref, make_token_batch(ref.jm.cfg.vocab, N_DOCS, 12, seed=3)


def test_embed_tokens_matches_reference(rag_docs):
    ref, docs = rag_docs
    from repro.serve.rag import embed_tokens as j_embed
    np.testing.assert_array_equal(embed_tokens(ref.tp, docs),
                                  j_embed(ref.jp, docs))


@pytest.mark.parametrize("batch", [0, 8])
def test_rag_matches_reference(rag_docs, batch):
    """Retrieval ids and I/O stats identical to the reference pipeline's
    (and every integer BatchReport field on the batched path); the answer's
    tokens are the widened-cache reference loop's on the same prompt."""
    ref, docs = rag_docs
    j_rag = JRAGPipeline(JServeEngine(ref.jm, ref.jp), doc_tokens=docs, k=2,
                         batch=batch)
    t_rag = RAGPipeline(port_engine(ref), doc_tokens=docs, k=2, batch=batch)
    queries = make_token_batch(ref.jm.cfg.vocab, B, 8, seed=11)
    j_ids, j_stats = j_rag.retrieve(queries)
    t_ids, t_stats = t_rag.retrieve(queries)
    np.testing.assert_array_equal(t_ids, j_ids)
    for key in ("graph_ios", "vector_ios", "cache_hits"):
        assert t_stats[key] == j_stats[key], key
    if batch:
        assert t_stats["buckets"] == j_stats["buckets"]
        assert t_stats["modeled_latency_us"] == pytest.approx(
            j_stats["modeled_latency_us"], rel=1e-12)
        rep = t_stats["report"]
        for name in ("n_queries", "n_padded", "pq_ops", "exact_ops",
                     "decompressions", "io_rounds", "rerank_batches"):
            assert isinstance(getattr(rep, name), int), name
    gen, stats = t_rag.answer(queries, max_new=MAX_NEW)
    np.testing.assert_array_equal(stats["retrieved"], j_ids)
    prompt = np.concatenate([docs[j_ids].reshape(B, -1), queries], 1)
    reference_greedy(ref, {"tokens": prompt}, gen)


# ----------------------------------------------------------------- launcher
@pytest.mark.parametrize("argv", [
    [], ["--rag"], ["--arch", "seamless-m4t-medium"]],
    ids=["plain", "rag", "encdec"])
def test_launcher_on_cpu(argv, capsys):
    out, stats = launch_serve.main(["--device", "cpu", "--requests", "2",
                                    "--max-new", "4"] + argv)
    text = capsys.readouterr().out
    assert out.shape == (2, 4)
    assert "2 requests x 4 new tokens" in text and "on cpu" in text
    if "--rag" in argv:
        assert "graph" in text and stats["retrieved"].shape == (2, 2)


def test_launcher_refuses_a_mesh():
    """``--mesh pod`` is accepted, and one process cannot hold the
    production mesh: it raises with the reference's message."""
    with pytest.raises(RuntimeError, match="need 256 devices .*have 1"):
        launch_serve.main(["--device", "cpu", "--mesh", "pod"])


class _RefSplitRows:
    """The reference's vector store holding rows as ``parts`` slices,
    read back as whole rows (the port's ``SplitRows`` on the reference)."""

    def __init__(self, store, parts, dim):
        self.store, self.parts, self.dim, self.io = store, parts, dim, \
            store.io

    def get(self, ids):
        ids = np.asarray(ids, np.int64)
        sub = (ids[:, None] * self.parts + np.arange(self.parts)).reshape(-1)
        return np.asarray(self.store.get(sub)).reshape(len(ids), self.dim)


def test_rag_rows_wider_than_a_block():
    """At d_model 2,048 a float32 row (8 KB) does not fit a 4 KiB block:
    the reference's RAGPipeline raises while sealing its vector store. The
    port stores each row as 4 slices of 2 KB; its host retrieval (batch=0)
    equals the reference's search_decoupled over the reference's store
    holding the same slices: ids and I/O stats."""
    jm = JModel.from_config(reduce_config(get_config("internlm2-1.8b"),
                                          d_model=2048))
    jp = jm.init(jax.random.PRNGKey(0))
    docs = make_token_batch(jm.cfg.vocab, 200, 12, seed=3)
    with pytest.raises(ValueError, match="record larger than a block"):
        JRAGPipeline(JServeEngine(jm, jp), doc_tokens=docs, k=2)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tm = Model.from_config(t_reduce_config(t_get_config("internlm2-1.8b"),
                                           d_model=2048))
    t_rag = RAGPipeline(ServeEngine(tm, tp, device="cpu"), doc_tokens=docs,
                        k=2)
    assert t_rag.vector_store.parts == 4
    vecs = embed_tokens(tp, docs)
    np.testing.assert_array_equal(
        t_rag.vector_store.get(np.array([7, 0, 199])).numpy(),
        vecs[[7, 0, 199]])
    jvs = JVS(JSC(dim=512, dtype=np.float32, segment_capacity=4096))
    jvs.append(np.arange(800), vecs.reshape(800, 512))
    jvs.seal_active()
    jis = JIS.from_graph(t_rag.graph.adjacency, t_rag.graph.medoid, 16,
                         cache_bytes=1 << 16)
    queries = make_token_batch(jm.cfg.vocab, 3, 8, seed=11)
    t_ids, t_stats = t_rag.retrieve(queries)
    # the reference's config with the port's values (the reference's has
    # a kernel_backend field too, which the port does not)
    jcfg = JEngineConfig(**dataclasses.asdict(t_rag.cfg))
    want = [search_decoupled(jis, _RefSplitRows(jvs, 4, 2048), t_rag.codes,
                             t_rag.cb, row, jcfg)
            for row in embed_tokens(tp, queries)]
    np.testing.assert_array_equal(t_ids, np.stack([i[:2] for i, _ in want]))
    for key in ("graph_ios", "vector_ios", "cache_hits"):
        assert t_stats[key] == sum(getattr(s, key) for _, s in want), key
