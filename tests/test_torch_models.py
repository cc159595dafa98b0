"""CPU parity of ``repro_torch.models`` (the LM serving path's layers,
MoE, state-space mixers, schemas and forwards) with the JAX reference
``repro.models``. Every case draws its inputs from a seeded numpy
generator (or the reference's own ``init``), runs them through the
reference (eager or ``jit``, as its own tests do) and through the port,
and compares with the tolerance stated beside it. Reference params reach
the port through ``params_from_numpy``.

Tolerances: float32 throughout, but for one bfloat16 case of the serving
dtype (``BF16_ATOL``, set from the gaps measured and stated there). Layers
that do the same arithmetic in the same order are held to 1e-6 (rms_norm,
rope, the MLPs); attention,
the MoE and the scans sum in another order (einsum contraction order,
softmax, a Hillis–Steele scan against XLA's tree scan) and are held to
1e-5 relative + 1e-5 absolute; whole-model logits, which are O(1–50), to
1e-4 absolute.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import ARCHS, SHAPES, applicable, get_config, reduce_config
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.api import Model as JModel

from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import applicable as t_applicable
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_config as t_reduce_config
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.api import Model
from repro_torch.models.schema import params_from_numpy, tree_leaves
from repro_torch.serve.engine import widen_cache

from torch_lm_parity import (B, ENC_FRAMES, MAX_NEW, arch_batch, as_jax,
                             as_torch, prompt_len, reference, widen_np)

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_ATOL = 1e-4


def close(ref, got, **tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(ref, dtype=np.float32), **tol)


def normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


T = torch.from_numpy


# ------------------------------------------------------------------ layers
def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x, g = normal(rng, 2, 5, 4, 16), normal(rng, 16, scale=0.1)
    close(jl.rms_norm(jnp.asarray(x), jnp.asarray(g)),
          tl.rms_norm(T(x), T(g)), rtol=1e-6, atol=1e-6)
    pos = rng.integers(0, 4096, size=(2, 5))
    for theta in (1e4, 1e6):
        close(jl.rope(jnp.asarray(x), jnp.asarray(pos), theta),
              tl.rope(T(x), T(pos), theta), rtol=1e-6, atol=1e-5)


# The cases of tests/test_layers.py (GQA, MHA with a window, wide GQA, one
# query against 40 keys) plus softcap, a kv_mask and q chunks.
ATTN_CASES = [
    dict(sq=16, skv=16, h=4, kvh=2),
    dict(sq=32, skv=32, h=4, kvh=4, window=8),
    dict(sq=64, skv=64, h=8, kvh=2),
    dict(sq=1, skv=40, h=4, kvh=2),
    dict(sq=16, skv=16, h=4, kvh=2, softcap=5.0),
    dict(sq=1, skv=24, h=4, kvh=1, kv_mask=True),
    dict(sq=40, skv=40, h=4, kvh=2, q_chunk=16),
    dict(sq=40, skv=40, h=4, kvh=2, q_chunk=16, window=12, softcap=3.0),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_attention_dense_and_flash(case):
    case = dict(case)
    sq, skv, h, kvh = (case.pop(k) for k in ("sq", "skv", "h", "kvh"))
    rng = np.random.default_rng(sq * 100 + skv)
    b, hd = 2, 16
    q, k, v = (normal(rng, b, sq, h, hd), normal(rng, b, skv, kvh, hd),
               normal(rng, b, skv, kvh, hd))
    kw = dict(causal=sq == skv, window=case.get("window"),
              softcap=case.get("softcap"))
    jkw, tkw = dict(kw), dict(kw)
    if case.get("kv_mask"):
        m = np.arange(skv)[None] < np.array([[7], [skv]])
        jkw["kv_mask"], tkw["kv_mask"] = jnp.asarray(m), T(m)
    if "q_chunk" in case:
        jkw["q_chunk"] = tkw["q_chunk"] = case["q_chunk"]
    ref = jl.attention_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **jkw)
    close(ref, tl.attention_dense(T(q), T(k), T(v), **tkw), **LAYER_TOL)
    if not case.get("kv_mask"):
        fkw = dict(kw, q_chunk=8, kv_chunk=8)
        jf = jl.attention_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **fkw)
        close(jf, tl.attention_flash(T(q), T(k), T(v), **fkw), **LAYER_TOL)
        close(ref, tl.attention_flash(T(q), T(k), T(v), **fkw),
              rtol=2e-4, atol=2e-4)       # the reference's dense == flash


def test_mlps():
    rng = np.random.default_rng(3)
    x = normal(rng, 2, 7, 16)
    wg, wu, wd = normal(rng, 16, 32), normal(rng, 16, 32), normal(rng, 32, 16)
    bu, bd = normal(rng, 32), normal(rng, 16)
    close(jl.swiglu(*map(jnp.asarray, (x, wg, wu, wd))),
          tl.swiglu(*map(T, (x, wg, wu, wd))), rtol=1e-6, atol=1e-5)
    close(jl.gelu_mlp(*map(jnp.asarray, (x, wu, bu, wd, bd))),
          tl.gelu_mlp(*map(T, (x, wu, bu, wd, bd))), rtol=1e-6, atol=1e-5)


# --------------------------------------------------------------------- MoE
def moe_params(rng, d, cfg, scale=0.2):
    e, f = cfg.n_experts, cfg.d_expert
    p = {"router": normal(rng, d, e, scale=scale),
         "w_gate": normal(rng, e, d, f, scale=scale),
         "w_up": normal(rng, e, d, f, scale=scale),
         "w_down": normal(rng, e, f, d, scale=scale)}
    if cfg.n_shared:
        fs = cfg.n_shared * f
        p |= {"shared_w_gate": normal(rng, d, fs, scale=scale),
              "shared_w_up": normal(rng, d, fs, scale=scale),
              "shared_w_down": normal(rng, fs, d, scale=scale)}
    return p


@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("phase", ["train", "decode"])
def test_moe_layer(n_shared, phase):
    rng = np.random.default_rng(4 + n_shared)
    d = 12
    jcfg = jmoe.MoEConfig(n_experts=8, top_k=2, d_expert=16,
                          n_shared=n_shared)
    tcfg = tmoe.MoEConfig(n_experts=8, top_k=2, d_expert=16,
                          n_shared=n_shared)
    p = moe_params(rng, d, jcfg)
    s = 1 if phase == "decode" else 24
    x = normal(rng, 3, s, d, scale=0.5)
    jy, jaux = jax.jit(lambda pp, xx: jmoe.moe_layer(xx, pp, jcfg, phase))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    ty, taux = tmoe.moe_layer(T(x), {k: T(v) for k, v in p.items()}, tcfg,
                              phase)
    close(jy, ty, **LAYER_TOL)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_moe_dispatch_with_router_ties():
    """A zero router gives every expert the same probability: the top-k
    takes the lowest expert ids, the stable sort keeps tokens in order, so
    which tokens overflow capacity is the reference's exactly."""
    rng = np.random.default_rng(6)
    d, e, k = 8, 4, 2
    cfg_j = jmoe.MoEConfig(n_experts=e, top_k=k, d_expert=8)
    cfg_t = tmoe.MoEConfig(n_experts=e, top_k=k, d_expert=8)
    p = moe_params(rng, d, cfg_j)
    p["router"][:] = 0.0
    x = normal(rng, 2, 10, d)
    jy, jaux = jax.jit(lambda pp, xx: jmoe.moe_layer(xx, pp, cfg_j))(
        {kk: jnp.asarray(v) for kk, v in p.items()}, jnp.asarray(x))
    ty, taux = tmoe.moe_layer(T(x), {kk: T(v) for kk, v in p.items()}, cfg_t)
    close(jy, ty, **LAYER_TOL)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    probs = np.full((5, e), 0.25, np.float32)
    probs[1, 3] = probs[1, 2] = 0.3              # a tie above the rest
    jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
    tv, ti = tmoe.stable_topk(T(probs), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # one group with tied expert ids: slots, order, kept flags identical
    t, cap = 12, 3
    flat = normal(rng, t, d)
    gi = rng.integers(0, 2, size=(t, k)).astype(np.int32)   # experts 0/1 only
    gv = rng.uniform(0.1, 1, size=(t, k)).astype(np.float32)
    jx, jmeta = jmoe._dispatch_one_group(jnp.asarray(flat), jnp.asarray(gi),
                                         jnp.asarray(gv), e, k, cap)
    tx, tmeta = tmoe._dispatch_one_group(T(flat), T(gi).long(), T(gv), e, k,
                                         cap)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    for a, b in zip(jmeta, tmeta):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    ye = normal(rng, e, cap, d)
    close(jmoe._combine_one_group(jnp.asarray(ye), jmeta, t, d),
          tmoe._combine_one_group(T(ye), tmeta, t, d), rtol=1e-6, atol=1e-6)
    counts = np.bincount(tmeta[0].numpy()[tmeta[3].numpy()] // cap,
                         minlength=e)
    assert (counts <= cap).all()


# --------------------------------------------------------------------- SSM
@pytest.mark.parametrize("mode,s,chunk", [("assoc", 64, 0), ("chunk", 64, 16),
                                          ("chunk", 96, 32),
                                          ("chunk", 128, 128)])
def test_diag_ssm_scan(mode, s, chunk):
    rng = np.random.default_rng(1)
    b, di, ds = 2, 8, 4
    # decays down to exp(-30): a cumprod of them underflows, the combine
    # does not
    alpha = np.exp(-rng.uniform(0.01, 30.0, size=(b, s, di, ds))
                   ).astype(np.float32)
    u, h0 = normal(rng, b, s, di, ds), normal(rng, b, di, ds)
    kw = dict(mode=mode) | (dict(chunk=chunk) if chunk else {})
    jh, jlast = jax.jit(lambda a, uu, h: jssm.diag_ssm_scan(a, uu, h, **kw))(
        jnp.asarray(alpha), jnp.asarray(u), jnp.asarray(h0))
    th, tlast = tssm.diag_ssm_scan(T(alpha), T(u), T(h0), **kw)
    close(jh, th, **LAYER_TOL)
    close(jlast, tlast, **LAYER_TOL)
    h = h0.astype(np.float64)                    # sequential truth
    for t in range(s):
        h = alpha[:, t] * h + u[:, t]
    close(h, tlast, rtol=1e-4, atol=1e-5)


def mamba_params(rng, d, mcfg):
    di = mcfg.expand * d
    dtr = -(-d // 16)
    return {"in_proj": normal(rng, d, 2 * di, scale=0.3),
            "conv_w": normal(rng, mcfg.d_conv, di, scale=0.3),
            "conv_b": np.zeros(di, np.float32),
            "x_proj": normal(rng, di, dtr + 2 * mcfg.d_state, scale=0.3),
            "dt_proj": normal(rng, dtr, di, scale=0.3),
            "dt_bias": np.zeros(di, np.float32),
            "A_log": np.broadcast_to(np.log(np.arange(1, mcfg.d_state + 1,
                                                      dtype=np.float32)),
                                     (di, mcfg.d_state)).copy(),
            "D": np.ones(di, np.float32),
            "out_proj": normal(rng, di, d, scale=0.3)}


@pytest.mark.parametrize("mode", ["chunk", "assoc"])
def test_mamba_prefill_then_step(mode):
    """Prefill over S - 1 tokens then one step, each against the
    reference, and the step against the full sequence's last row."""
    rng = np.random.default_rng(2)
    jm = jssm.MambaConfig(d_state=4, d_conv=4, expand=2)
    tm = tssm.MambaConfig(d_state=4, d_conv=4, expand=2)
    d, s = 16, 24
    p = mamba_params(rng, d, jm)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: T(v) for k, v in p.items()}
    x = normal(rng, 2, s, d, scale=0.5)
    jy, jst = jax.jit(lambda xx, pp: jssm.mamba_forward(xx, pp, jm,
                                                        mode=mode))(
        jnp.asarray(x[:, :s - 1]), jp)
    ty, tst = tssm.mamba_forward(T(x[:, :s - 1]), tp, tm, mode=mode)
    close(jy, ty, **LAYER_TOL)
    for a, b in zip(jst, tst):
        close(a, b, **LAYER_TOL)
    jys, _ = jax.jit(lambda xx, pp, st: jssm.mamba_forward(
        xx, pp, jm, state=st, mode="step"))(jnp.asarray(x[:, s - 1:]), jp, jst)
    tys, _ = tssm.mamba_forward(T(x[:, s - 1:]), tp, tm, state=tst,
                                mode="step")
    close(jys, tys, **LAYER_TOL)
    tfull, _ = tssm.mamba_forward(T(x), tp, tm, mode=mode)
    close(tfull[:, -1], tys[:, 0], rtol=2e-3, atol=2e-4)


def rwkv_params(rng, d, rcfg):
    dk = rcfg.head_dim
    h = d // dk
    z = lambda *s: np.zeros(s, np.float32)
    return {"mu_r": z(d), "mu_k": z(d), "mu_v": z(d), "mu_w": z(d),
            "mu_g": z(d),
            "w_r": normal(rng, d, h * dk, scale=0.3),
            "w_k": normal(rng, d, h * dk, scale=0.3),
            "w_v": normal(rng, d, h * dk, scale=0.3),
            "w_g": normal(rng, d, h * dk, scale=0.3),
            "w_o": normal(rng, h * dk, d, scale=0.3),
            "w0": z(h * dk) - 0.5, "w1": normal(rng, d, 8, scale=0.3),
            "w2": normal(rng, 8, h * dk, scale=0.03),
            "u": normal(rng, h, dk, scale=0.3), "ln_x": np.ones(h * dk,
                                                                np.float32)}


def test_rwkv_chunk_and_step():
    rng = np.random.default_rng(5)
    jr, tr = jssm.RWKVConfig(head_dim=8, decay_lora=8), \
        tssm.RWKVConfig(head_dim=8, decay_lora=8)
    d, s = 16, 64
    p = rwkv_params(rng, d, jr)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: T(v) for k, v in p.items()}
    x = normal(rng, 2, s, d, scale=0.5)
    jy, (jxp, jss) = jax.jit(lambda xx, pp: jssm.rwkv_time_mix(
        xx, pp, jr, mode="chunk", chunk=16))(jnp.asarray(x), jp)
    ty, (txp, tss) = tssm.rwkv_time_mix(T(x), tp, tr, mode="chunk", chunk=16)
    close(jy, ty, **LAYER_TOL)
    close(jss, tss, **LAYER_TOL)
    st, ys = None, []
    for t in range(s):
        y_t, st = tssm.rwkv_time_mix(T(x[:, t:t + 1]), tp, tr, state=st,
                                     mode="step")
        ys.append(y_t[:, 0])
    close(ty, torch.stack(ys, 1), rtol=2e-3, atol=2e-3)
    close(tss, st[1], rtol=1e-3, atol=1e-3)
    jc, jxc = jssm.rwkv_channel_mix(jnp.asarray(x), {
        "mu_kc": jnp.asarray(p["mu_r"]), "mu_rc": jnp.asarray(p["mu_k"]),
        "w_rc": jnp.asarray(p["w_r"]), "w_kc": jnp.asarray(p["w_k"]),
        "w_vc": jnp.asarray(p["w_v"])})
    tc, txc = tssm.rwkv_channel_mix(T(x), {
        "mu_kc": T(p["mu_r"]), "mu_rc": T(p["mu_k"]), "w_rc": T(p["w_r"]),
        "w_kc": T(p["w_k"]), "w_vc": T(p["w_v"])})
    close(jc, tc, **LAYER_TOL)
    close(jxc, txc, rtol=0, atol=0)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_match_reference(arch):
    """The arch's full and reduced configs carry the reference's values
    field for field (layer pattern, MoE, SSM), and the shape cells and
    their applicability are the reference's."""
    full, t_full = get_config(arch), t_get_config(arch)
    for a, b in ((full, t_full), (reduce_config(full), t_reduce_config(t_full))):
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert (b.n_periods, len(b.all_descs)) == (a.n_periods,
                                                   len(a.all_descs))
    assert {k: dataclasses.asdict(v) for k, v in T_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in SHAPES.items()}
    for name in SHAPES:
        assert t_applicable(t_full, T_SHAPES[name]) == \
            applicable(full, SHAPES[name])


# ----------------------------------------------------------------- schemas
def shapes_of(tree, leaves_fn):
    return [tuple(x.shape) for x in leaves_fn(tree)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_schema_matches_reference(arch):
    """Every leaf of the full config's params (keys, order, stacked
    shapes) and the parameter count equal the reference's; the port's
    abstract params are ``meta`` tensors (nothing allocated)."""
    jm = JModel.from_config(get_config(arch))
    tm = Model.from_config(t_get_config(arch))
    jabs = jm.abstract_params()
    tabs = tm.abstract_params()
    jpaths = [jax.tree_util.keystr(k) for k, _ in
              jax.tree_util.tree_flatten_with_path(jabs)[0]]
    tpaths = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + f"['{k}']")
        else:
            tpaths.append(path)
    walk(tabs, "")
    assert tpaths == jpaths
    assert shapes_of(tabs, tree_leaves) == \
        shapes_of(jabs, jax.tree_util.tree_leaves)
    assert all(x.device.type == "meta" for x in tree_leaves(tabs))
    assert {x.dtype for x in tree_leaves(tabs)} == {torch.bfloat16}
    assert tm.n_params() == jm.n_params()
    jc = jm.abstract_cache(2, 64)
    tc = tm.abstract_cache(2, 64)
    assert shapes_of(tc, tree_leaves) == \
        shapes_of(jc, jax.tree_util.tree_leaves)
    assert [str(x.dtype).removeprefix("torch.") for x in tree_leaves(tc)] \
        == [str(x.dtype) for x in jax.tree_util.tree_leaves(jc)]


# ------------------------------------------------------------------- archs
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and cache, then one decode step at position S from
    the reference's own cache widened by MAX_NEW slots (logits and the new
    cache), against the reference. The encoder-decoder's prefill differs on
    purpose in its self-K/V (the port fills it from the prompt;
    tests/test_torch_lm_serve.py pins that), so there the cross-K/V are
    compared and the step starts from the reference's cache."""
    ref = reference(arch)
    cfg = ref.jm.cfg
    batch = arch_batch(cfg)
    jl_, jc = ref.prefill(ref.jp, as_jax(batch))
    with torch.no_grad():
        tl_, tc = ref.tm.prefill(ref.tp, as_torch(batch), attn_mode="dense")
    close(jl_, tl_, rtol=0, atol=LOGIT_ATOL)
    if cfg.encoder_layers:
        for key in ("xk", "xv"):
            close(jc[key], tc[key], **LAYER_TOL)
        assert tc["k"].shape == jc["k"].shape
    else:
        jleaves, tleaves = jax.tree_util.tree_leaves(jc), tree_leaves(tc)
        assert [tuple(x.shape) for x in tleaves] == \
            [tuple(x.shape) for x in jleaves]
        for a, b in zip(jleaves, tleaves):
            close(a, b, **LAYER_TOL)
    n = prompt_len(cfg, batch)
    s_enc = ENC_FRAMES if cfg.encoder_layers else 0
    jc = widen_np(ref.jm, jc, B, n + MAX_NEW, s_enc)
    pos = np.full((B,), n, np.int32)
    tok = batch["tokens"][:, -1:]
    jl2, jc2 = ref.decode(ref.jp, jc, jnp.asarray(tok), jnp.asarray(pos))
    with torch.no_grad():
        tl2, tc2 = ref.tm.decode_step(ref.tp, params_from_numpy(jc, "cpu"),
                                      T(tok).long(), T(pos).long())
    close(jl2, tl2, rtol=0, atol=LOGIT_ATOL)
    for a, b in zip(jax.tree_util.tree_leaves(jc2), tree_leaves(tc2)):
        close(a, b, **LAYER_TOL)


#: bfloat16 tolerances (max and mean absolute gap of the logits, O(1) here)
#: of the port against the reference, each arch reduced and run in
#: bfloat16 on the same weights: prefill + 4 greedy decode steps. The two
#: round each bfloat16 product and sum after accumulating in another order,
#: so 68-88% of the logits differ by an ulp or more (2^-7 = 0.0078 at 1-2)
#: and the gaps compound through the layers. On seed 0 the gaps measured
#: (max / mean) 2.34e-2 / 3.68e-3 (internlm2), 3.13e-2 / 6.10e-3
#: (deepseek-moe), 7.03e-2 / 1.29e-2 (jamba), 2.34e-2 / 3.87e-3 (rwkv6);
#: the limits sit 1.15-1.3x above them. An rms_norm computed in bfloat16
#: (the reference computes it in float32) gives 3.91e-2 / 5.44e-3,
#: 4.69e-2 / 7.11e-3, 3.01e-1 / 2.30e-2 and 4.69e-2 / 6.34e-3: past every
#: limit.
BF16_ATOL = {"internlm2-1.8b": (3.0e-2, 4.5e-3),
             "deepseek-moe-16b": (4.0e-2, 7.0e-3),
             "jamba-v0.1-52b": (9.0e-2, 1.6e-2),
             "rwkv6-1.6b": (3.0e-2, 4.8e-3)}


@pytest.mark.parametrize("arch", sorted(BF16_ATOL))
def test_bfloat16_serve_matches_reference(arch):
    """The serving dtype: each arch reduced in bfloat16 (dense GQA, MoE
    with shared experts, Mamba + MoE, RWKV), the reference's jitted
    prefill and decode steps against the port's on the same bfloat16
    weights, 4 decode steps over a widened cache fed the reference's greedy
    tokens. Logits and every cache leaf keep the reference's dtypes; the
    logits agree within ``BF16_ATOL``."""
    jm = JModel.from_config(dataclasses.replace(
        reduce_config(get_config(arch)), dtype="bfloat16"))
    tm = Model.from_config(dataclasses.replace(
        t_reduce_config(t_get_config(arch)), dtype="bfloat16"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert {x.dtype for x in tree_leaves(tp)} == {torch.bfloat16}
    batch = arch_batch(jm.cfg)
    jlog, jc = jax.jit(lambda p, b: jm.prefill(p, b, attn_mode="dense"))(
        jp, as_jax(batch))
    with torch.no_grad():
        tlog, tc = tm.prefill(tp, as_torch(batch), attn_mode="dense")
    n = prompt_len(jm.cfg, batch)
    jc = widen_np(jm, jc, B, n + MAX_NEW)
    tc = widen_cache(tm, tc, B, n + MAX_NEW)
    decode = jax.jit(jm.decode_step)
    pos = np.full((B,), n, np.int32)
    want, got = [np.asarray(jlog[:, -1], np.float32)], [tlog[:, -1]]
    for _ in range(MAX_NEW):
        tok = want[-1].argmax(-1)[:, None]
        jlog, jc = decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        with torch.no_grad():
            tlog, tc = tm.decode_step(tp, tc, T(tok).long(), T(pos).long())
        want.append(np.asarray(jlog[:, -1], np.float32))
        got.append(tlog[:, -1])
        pos = pos + 1
    assert str(tlog.dtype).removeprefix("torch.") == str(jlog.dtype)
    assert [str(x.dtype).removeprefix("torch.") for x in tree_leaves(tc)] \
        == [str(x.dtype) for x in jax.tree_util.tree_leaves(jc)]
    gap = np.abs(np.stack([g.float().numpy() for g in got]) - np.stack(want))
    max_atol, mean_atol = BF16_ATOL[arch]
    assert gap.max() <= max_atol and gap.mean() <= mean_atol, \
        (gap.max(), gap.mean())
