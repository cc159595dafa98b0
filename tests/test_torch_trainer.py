"""CPU parity of the port's optimizer and trainer with the JAX reference:
``warmup_cosine``, ``global_norm``, ``adamw_update`` (fp32 master, clipped
and unclipped, float32 and bfloat16 params), ``make_train_step`` against
the reference's jitted step (1 and 2 microbatches), ``TrainLoop``'s loss
history against the reference's ``TrainLoop`` on the same batches, and
restart determinism. Inputs come from numpy seeds and the reference's own
``init``.

Tolerances (float32): the schedule 1e-7 absolute; the global norm 1e-6
relative (the sums of squares fold in another order); AdamW's m, v and
master 1e-6 relative (unclipped they are bit-equal: the same ops in the
same order; a clipped step inherits the norm's last bit); params after a
train step 1e-6 absolute (measured 2.4e-07); losses 1e-5 relative per
step, a 4-step history 1e-4 (the reference's own restart tolerance).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.optim import adamw as jadamw
from repro.optim.schedule import warmup_cosine as j_warmup_cosine
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import TrainLoop as JTrainLoop
from repro.train.trainer import make_train_step as j_make_train_step

from repro_torch.data.pipeline import TokenPipeline
from repro_torch.ft.checkpoint import (latest_step, restore_checkpoint,
                                       save_checkpoint)
from repro_torch.models.schema import (opt_state_from_numpy,
                                       params_from_numpy, tree_leaves,
                                       tree_map)
from repro_torch.optim.adamw import (AdamWConfig, abstract_opt_state,
                                     adamw_update, global_norm,
                                     init_opt_state)
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.trainer import TrainConfig, TrainLoop, make_train_step

from torch_train_parity import (LOSS_RTOL, as_jax, as_torch, port_params,
                                reference, to_np, train_batch)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(64, 32)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(7,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(3, 5, 9)) * scale
                        ).astype(np.float32)}}


def _leaves_np(tree):
    return [t.float().numpy() for t in tree_leaves(tree)]


# ---------------------------------------------------------------- schedule
@pytest.mark.parametrize("warmup,total", [(100, 10_000), (3, 15), (0, 8),
                                          (5, 5)])
def test_warmup_cosine_matches_reference(warmup, total):
    steps = np.arange(0, total + 6)
    want = np.asarray([float(j_warmup_cosine(s, warmup=warmup, total=total))
                       for s in steps])
    got = np.asarray([float(warmup_cosine(torch.tensor(int(s)),
                                          warmup=warmup, total=total))
                      for s in steps])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got[0] == 0.0                 # step 0 moves nothing


def test_global_norm_matches_reference():
    tree = _tree(0)
    want = float(jadamw.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                           tree)))
    got = float(global_norm(params_from_numpy(tree, "cpu")))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    bf = float(global_norm(params_from_numpy(tree, "cpu", torch.bfloat16)))
    jbf = float(jadamw.global_norm(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), tree)))
    np.testing.assert_allclose(bf, jbf, rtol=1e-6)


# ------------------------------------------------------------------- AdamW
def test_opt_state_layout():
    """m, v zero, the master an fp32 copy (not an alias of float32 params),
    step 0; the abstract state has the same shapes on ``meta``."""
    params = params_from_numpy(_tree(1), "cpu")
    st = init_opt_state(params)
    assert sorted(st) == ["m", "master", "step", "v"]
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    for p, w in zip(tree_leaves(params), tree_leaves(st["master"])):
        assert w.dtype == torch.float32 and torch.equal(p, w)
        assert w.data_ptr() != p.data_ptr()
    ab = abstract_opt_state(tree_map(lambda t: t.to("meta"), params))
    for a, b in zip(tree_leaves(ab), tree_leaves(st)):
        assert a.device.type == "meta" and a.shape == b.shape and \
            a.dtype == b.dtype


@pytest.mark.parametrize("clip", [False, True], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(clip, dtype):
    """Three updates from identical grads and state, lr_scale from the
    schedule (0 at step 0): m, v and master within 1e-6 relative, the
    grad norm within 1e-6, the params the cast of the master and equal to
    the reference's wherever the two masters are equal."""
    params = _tree(2)
    grads = _tree(3, scale=100.0 if clip else 0.01)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jst = jadamw.init_opt_state(jax.tree_util.tree_map(jnp.asarray, params))
    tst = opt_state_from_numpy(to_np(jst), "cpu")
    for _ in range(3):
        jp, jst, jm = jadamw.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, grads), jst,
            jadamw.AdamWConfig(), lr_scale=j_warmup_cosine(
                jst["step"], warmup=2, total=10), model_dtype=jdt)
        tp, tst, tm = adamw_update(
            params_from_numpy(grads, "cpu"), tst, AdamWConfig(),
            lr_scale=warmup_cosine(tst["step"], warmup=2, total=10),
            model_dtype=tdt)
        assert (float(jm["grad_norm"]) > 1.0) == clip
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(tm["step"]) == int(jm["step"])
        for k in ("m", "v", "master"):
            for a, b in zip(jax.tree_util.tree_leaves(jst[k]),
                            _leaves_np(tst[k])):
                np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                           atol=1e-12)
                if not clip:
                    np.testing.assert_array_equal(b, np.asarray(a))
        for p, w, jw, jpp in zip(tree_leaves(tp), tree_leaves(tst["master"]),
                                 jax.tree_util.tree_leaves(jst["master"]),
                                 jax.tree_util.tree_leaves(jp)):
            assert p.dtype == tdt
            assert torch.equal(p, w.to(tdt))
            same = w.numpy() == np.asarray(jw)
            np.testing.assert_array_equal(
                p.float().numpy()[same],
                np.asarray(jpp.astype(jnp.float32))[same])


# -------------------------------------------------------------- train step
@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b"])
def test_train_step_matches_reference(arch, mb):
    """Three steps of ``make_train_step`` (batch 4, split into ``mb``
    microbatches) against the reference's jitted step: loss and grad norm
    each step, params after each step."""
    ref = reference(arch)
    kw = dict(microbatches=mb, remat=None, attn_mode="dense", warmup=2,
              total_steps=10)
    jstep = jax.jit(j_make_train_step(ref.jm, jadamw.AdamWConfig(lr=1e-3),
                                      JTrainConfig(**kw)))
    tstep = make_train_step(ref.tm, AdamWConfig(lr=1e-3), TrainConfig(**kw))
    jp, js = ref.jp, jadamw.init_opt_state(ref.jp)
    tp = port_params(ref)
    ts = init_opt_state(tp)
    for i in range(3):
        batch = train_batch(ref.jm.cfg, seed=10 + i, b=4)
        jp, js, jm = jstep(jp, js, as_jax(batch))
        tp, ts, tm = tstep(tp, ts, as_torch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(jp), _leaves_np(tp)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6)


def test_first_step_leaves_the_master_unchanged():
    """``warmup_cosine`` is 0 at step 0: the master stays the initial
    params upcast, bit for bit, while m and v take the gradients."""
    ref = reference("internlm2-1.8b")
    params = port_params(ref)
    st = init_opt_state(params)
    step = make_train_step(ref.tm, AdamWConfig(),
                           TrainConfig(remat=None, attn_mode="dense"))
    new, st, metrics = step(params, st, as_torch(train_batch(ref.jm.cfg)))
    assert int(st["step"]) == 1 and np.isfinite(float(metrics["loss"]))
    for p, w, q in zip(tree_leaves(params), tree_leaves(st["master"]),
                       tree_leaves(new)):
        assert torch.equal(w, p.float()) and torch.equal(q, p)
    assert all(float(m.abs().max()) > 0 for m in tree_leaves(st["m"]))
    assert all(float(v.abs().max()) > 0 for v in tree_leaves(st["v"]))


# ------------------------------------------------------------------- loops
def _pipes(cfg):
    return (JTokenPipeline(vocab=cfg.vocab, global_batch=4, seq_len=32),
            TokenPipeline(vocab=cfg.vocab, global_batch=4, seq_len=32))


def test_train_loop_history_matches_reference(tmp_path):
    """Four steps of ``TrainLoop`` on the reduced internlm2 (the reference's
    restart test's setup: lr 1e-3, dense attention, no remat) against the
    reference's ``TrainLoop`` on the same pipeline batches: the loss and
    grad-norm history within 1e-4; the port checkpoints every 2 steps."""
    ref = reference("internlm2-1.8b")
    jpipe, tpipe = _pipes(ref.jm.cfg)
    jloop = JTrainLoop(ref.jm, jadamw.AdamWConfig(lr=1e-3),
                       JTrainConfig(remat=None, attn_mode="dense"))
    _, _, want = jloop.run(ref.jp, [jpipe.batch_at(s) for s in range(4)])
    seen = []
    loop = TrainLoop(ref.tm, AdamWConfig(lr=1e-3),
                     TrainConfig(remat=None, attn_mode="dense"),
                     checkpoint_every=2, checkpoint_dir=str(tmp_path))
    _, _, got = loop.run(port_params(ref),
                         (tpipe.batch_at(s) for s in range(4)),
                         hooks=[lambda s, p, o, h: seen.append(s)])
    assert seen == [0, 1, 2, 3]
    assert [h["step"] for h in got] == [0, 1, 2, 3]
    assert all(h["sec"] > 0 for h in got)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in got],
                                   [h[key] for h in want], rtol=1e-4)
    assert latest_step(tmp_path) == 4
    assert (tmp_path / "step_00000002" / "manifest.json").exists()


def test_train_restart_is_deterministic(tmp_path):
    """Train 4 steps; train 2 + checkpoint + restore + 2: the same loss
    curve (the port's tests/test_ft.py::test_train_restart_is_deterministic)."""
    ref = reference("internlm2-1.8b")
    _, pipe = _pipes(ref.jm.cfg)
    tcfg = TrainConfig(remat=None, attn_mode="dense")

    def run(n_steps, params, opt, start=0):
        loop = TrainLoop(ref.tm, AdamWConfig(lr=1e-3), tcfg)
        batches = [pipe.batch_at(s) for s in range(start, start + n_steps)]
        return loop.run(params, batches, opt_state=opt, start_step=start)

    p0 = port_params(ref)
    _, _, hist_full = run(4, p0, init_opt_state(p0))
    p1 = port_params(ref)
    p1b, opt1b, hist_a = run(2, p1, init_opt_state(p1))
    save_checkpoint(tmp_path, 2, p1b, opt1b)
    restored, manifest = restore_checkpoint(tmp_path,
                                            {"params": p1b, "opt": opt1b})
    assert manifest["step"] == 2
    _, _, hist_b = run(2, restored["params"], restored["opt"], start=2)
    resumed = [h["loss"] for h in hist_a + hist_b]
    full = [h["loss"] for h in hist_full]
    np.testing.assert_allclose(resumed, full, rtol=1e-4)
