"""CPU parity of the port's data pipeline, fault tolerance, training
launcher and gradient compression with the JAX reference:

- ``TokenPipeline.batch_at`` (rank/world slices, corpus and synthetic) and
  ``StreamingVectorWorkload.cycles``: bit for bit;
- ``HeartbeatMonitor`` and ``StragglerMitigator``: the same event logs and
  plans under the same simulated clock and step times;
- checkpoints: the port's round trip; each package reads the other's
  float32 checkpoint bit for bit; bfloat16 leaves, which both packages
  write as raw ``|V2`` and the reference cannot restore, restore as
  bfloat16 in the port from either package's checkpoint, and raise under
  a template of another dtype (ROADMAP §3);
- ``python -m repro_torch.launch.train --device cpu`` with a restart (the
  port's tests/test_launchers.py::test_train_launcher, which fails in the
  reference);
- ``make_compressed_allreduce``: against the reference's ``shard_map``
  program (8 forced XLA host devices in a subprocess, the recipe of
  tests/test_distributed.py): q bit for bit, scales and means within
  1e-6, the residual equal; the gloo form (8 ranks) equals the stacked
  form bit for bit.
"""
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.data.pipeline import StreamingVectorWorkload as JWorkload
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.data.synthetic import make_vector_dataset
from repro.ft import checkpoint as jckpt
from repro.ft.heartbeat import HeartbeatMonitor as JHeartbeat
from repro.ft.straggler import StragglerMitigator as JStraggler
from repro.optim import adamw as jadamw
from repro.optim.grad_compress import quantize_int8 as j_quantize_int8

from repro_torch.core.distributed.sharded_index import make_mesh
from repro_torch.data.pipeline import StreamingVectorWorkload, TokenPipeline
from repro_torch.ft.checkpoint import (latest_step, restore_checkpoint,
                                       save_checkpoint)
from repro_torch.ft.heartbeat import HeartbeatMonitor
from repro_torch.ft.straggler import StragglerMitigator
from repro_torch.launch import train as launch_train
from repro_torch.models.schema import (opt_state_from_numpy, to_numpy,
                                       tree_leaves, tree_map)
from repro_torch.optim.adamw import init_opt_state
from repro_torch.optim.grad_compress import (dequantize_int8, init_residual,
                                             make_compressed_allreduce,
                                             quantize_int8)

from test_distributed import _run
from torch_compress_worker import MESHES
from torch_train_parity import port_params, reference, to_np

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("corpus", [False, True], ids=["synthetic", "corpus"])
def test_token_pipeline_matches_reference(corpus):
    rows = np.random.default_rng(4).integers(0, 100, size=(50, 17)) \
        if corpus else None
    kw = dict(vocab=100, global_batch=8, seq_len=16, seed=3, corpus=rows)
    ref, port = JTokenPipeline(**kw), TokenPipeline(**kw)
    for step in (0, 3, 11):
        for rank, world in ((0, 1), (0, 4), (3, 4), (1, 2)):
            want = ref.batch_at(step, rank=rank, world=world)
            got = port.batch_at(step, rank=rank, world=world)
            assert sorted(got) == ["labels", "tokens"]
            for k in want:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
    for want, got, _ in zip(ref, port, range(3)):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_streaming_vector_workload_matches_reference():
    base = make_vector_dataset("prop-like", 200, 8, seed=1).astype(np.float32)
    ref = list(JWorkload(base, replace_frac=0.5, iterations=4).cycles())
    got = list(StreamingVectorWorkload(base, replace_frac=0.5,
                                       iterations=4).cycles())
    assert len(got) == len(ref) == 4
    for a, b in zip(ref, got):
        assert a["iteration"] == b["iteration"]
        for k in ("delete", "insert_ids", "insert_vecs"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(b[k], a[k])


# -------------------------------------------------------- heartbeat, straggler
def _heartbeat_log(cls):
    """tests/test_ft.py's scenario plus a second failure and two rejoins,
    on a simulated clock: (check results, recoveries, incidents, healthy)."""
    t = [0.0]
    recoveries, checks = [], []
    mon = cls(4, timeout_s=10, clock=lambda: t[0],
              on_failure=lambda dead, healthy: recoveries.append(
                  (dead, healthy)))
    for w in range(4):
        mon.beat(w)
    for now, beats in ((5.0, ()), (12.0, (0, 1, 2)), (13.0, (3,)),
                       (30.0, (3,)), (31.0, (0, 1, 2)), (45.0, ())):
        t[0] = now
        for w in beats:
            mon.beat(w)
        checks.append(sorted(mon.check()))
    return checks, recoveries, mon.incidents, mon.healthy()


def test_heartbeat_matches_reference():
    assert _heartbeat_log(HeartbeatMonitor) == _heartbeat_log(JHeartbeat)


def _straggler_log(cls):
    m = cls(4, threshold=1.5, demote_after=2)
    plans = []
    for step in range(6):
        for w, dt in enumerate([1.0, 1.1, 0.9, 3.0 if step < 4 else 1.0]):
            m.record(w, dt * (1 + 0.1 * step))
        plans.append(m.plan())
    return plans, m.events, m.flags, m.demoted, m.times


def test_straggler_matches_reference():
    got, want = _straggler_log(StragglerMitigator), _straggler_log(JStraggler)
    assert got == want
    assert 3 in got[3]                  # the persistent straggler, demoted


# ------------------------------------------------------------- checkpoints
def _assert_tree_bits(got, want):
    """Port tensors against numpy/jax leaves: same dtype name, same bits."""
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        assert str(a.dtype).removeprefix("torch.") == b.dtype.name
        np.testing.assert_array_equal(
            np.atleast_1d(to_numpy(a)).view(np.uint8),
            np.atleast_1d(b).view(np.uint8))


def test_checkpoint_roundtrip(tmp_path):
    """The port's save/restore of params + optimizer state: equal bits, the
    manifest's step and extra, the latest complete step (a checkpoint
    without its manifest is ignored), and nothing to restore raises."""
    ref = reference("internlm2-1.8b")
    params = port_params(ref)
    opt = init_opt_state(params)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path, {"params": params})
    save_checkpoint(tmp_path, 7, params, opt, extra={"note": "x"})
    (tmp_path / "step_00000009").mkdir()          # incomplete: no manifest
    assert latest_step(tmp_path) == 7
    template = {"params": tree_map(lambda t: t.to("meta"), params),
                "opt": tree_map(lambda t: t.to("meta"), opt)}
    restored, manifest = restore_checkpoint(tmp_path, template,
                                            device="cpu")
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    for a, b in zip(tree_leaves(restored), tree_leaves({"params": params,
                                                         "opt": opt})):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_port_reads_a_reference_checkpoint(tmp_path):
    ref = reference("internlm2-1.8b")
    jopt = jadamw.init_opt_state(ref.jp)
    jckpt.save_checkpoint(tmp_path, 3, ref.jp, jopt)
    params = port_params(ref)
    got, manifest = restore_checkpoint(
        tmp_path, {"params": params, "opt": init_opt_state(params)})
    assert manifest["step"] == 3
    _assert_tree_bits(got, {"params": to_np(ref.jp), "opt": to_np(jopt)})


def test_reference_reads_a_port_checkpoint(tmp_path):
    ref = reference("internlm2-1.8b")
    params = port_params(ref)
    opt = opt_state_from_numpy(to_np(jadamw.init_opt_state(ref.jp)), "cpu")
    save_checkpoint(tmp_path, 5, params, opt)
    assert jckpt.latest_step(tmp_path) == 5
    got, _ = jckpt.restore_checkpoint(
        tmp_path, {"params": ref.jp, "opt": jadamw.init_opt_state(ref.jp)})
    _assert_tree_bits({"params": params, "opt": opt}, to_np(got))


def test_bf16_checkpoint_round_trip_and_the_reference_does_not(tmp_path):
    """A bfloat16 tree saved by the reference lands in the npz as raw
    ``|V2`` and its own restore hands the ``|V2`` back, which JAX refuses
    (so ``repro.launch.train --preset full`` cannot restart). The port
    restores both packages' bfloat16 checkpoints as bfloat16, bit for
    bit."""
    rng = np.random.default_rng(0)
    tree = {"w": jnp.asarray(rng.normal(size=(16, 8)), jnp.bfloat16),
            "b": {"g": jnp.asarray(rng.normal(size=(8,)), jnp.bfloat16)},
            "step": jnp.asarray(3, jnp.int32)}
    jckpt.save_checkpoint(tmp_path / "ref", 1, tree)
    with np.load(tmp_path / "ref" / "step_00000001" / "arrays.npz") as z:
        assert z["params/w"].dtype == np.dtype("V2")
    back, _ = jckpt.restore_checkpoint(tmp_path / "ref", {"params": tree})
    assert back["params"]["w"].dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        jnp.asarray(back["params"]["w"])

    template = {"params": {"w": torch.zeros((16, 8), dtype=torch.bfloat16),
                           "b": {"g": torch.zeros(8, dtype=torch.bfloat16)},
                           "step": torch.zeros((), dtype=torch.int32)}}
    got, _ = restore_checkpoint(tmp_path / "ref", template)
    assert got["params"]["w"].dtype == torch.bfloat16
    _assert_tree_bits(got["params"], to_np(tree))

    save_checkpoint(tmp_path / "port", 2, got["params"])
    again, _ = restore_checkpoint(tmp_path / "port", template)
    for a, b in zip(tree_leaves(again), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_bf16_checkpoint_holds_the_reference_bytes(tmp_path):
    """A bfloat16 leaf saved by the port lands in the npz as ``|V2``, the
    reference's own bytes: the reference's restore hands the ``|V2`` back
    (which JAX refuses, as on its own files) instead of integers; the
    port's bfloat16 round trip stays bit for bit."""
    w = torch.tensor([1.5391, -0.2930, -2.1719]).bfloat16()
    save_checkpoint(tmp_path, 1, {"w": w})
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
        assert z["params/w"].dtype == np.dtype("V2")
    back, _ = jckpt.restore_checkpoint(
        tmp_path, {"params": {"w": jnp.zeros(3, jnp.bfloat16)}})
    assert back["params"]["w"].dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        jnp.asarray(back["params"]["w"])
    got, _ = restore_checkpoint(tmp_path, {"params": {"w": torch.zeros(
        3, dtype=torch.bfloat16)}})
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"].view(torch.int16),
                       w.view(torch.int16))


@pytest.mark.parametrize("stored", ["V2", "uint16"])
def test_bf16_payload_under_another_template_raises(tmp_path, stored):
    """bfloat16 bits (``|V2``, or the uint16 of older port files) restore
    only under a bfloat16 template: under float32 the restore raises and
    names the leaf, where it used to return the integers."""
    bits = torch.tensor([1.5391, -0.2930, -2.1719]).bfloat16().view(
        torch.int16).numpy().view(np.dtype(stored))
    d = tmp_path / "step_00000001"
    d.mkdir()
    np.savez(d / "arrays.npz", **{"params/w": bits})
    (d / "manifest.json").write_text('{"step": 1}')
    with pytest.raises(TypeError, match="params/w"):
        restore_checkpoint(tmp_path, {"params": {"w": torch.zeros(3)}})
    got, _ = restore_checkpoint(tmp_path, {"params": {"w": torch.zeros(
        3, dtype=torch.bfloat16)}})
    assert got["params"]["w"].view(torch.int16).tolist() == \
        bits.view(np.int16).tolist()


def test_opt_state_numpy_round_trip():
    """The reference's optimizer state into the port and back, bit for bit;
    bfloat16 params back to ml_dtypes bfloat16 arrays."""
    ref = reference("internlm2-1.8b")
    jopt = to_np(jadamw.init_opt_state(ref.jp))
    opt = opt_state_from_numpy(jopt, "cpu")
    assert opt["step"].dtype == torch.int32
    _assert_tree_bits(opt, jopt)
    with pytest.raises(ValueError):
        opt_state_from_numpy({"m": jopt["m"]}, "cpu")
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                ref.jp)
    got = to_numpy(port_params(SimpleRef(to_np(bf))))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(to_np(bf))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


class SimpleRef:
    def __init__(self, np_params):
        self.np_params = np_params


# ---------------------------------------------------------------- launcher
def _launch(tmp_path, steps, every, capsys):
    hist = launch_train.main(["--device", "cpu", "--arch", "internlm2-1.8b",
                              "--preset", "smoke", "--steps", str(steps),
                              "--batch", "2", "--seq", "64", "--ckpt-every",
                              str(every), "--ckpt-dir", str(tmp_path)])
    return hist, capsys.readouterr().out


def test_train_launcher_on_cpu_with_restart(tmp_path, capsys):
    """6 steps checkpointed every 3, then a restart to step 8: it resumes
    at the checkpoint of step 6, and its two steps equal steps 6 and 7 of
    an uninterrupted 8-step run."""
    hist, out = _launch(tmp_path / "a", 6, 3, capsys)
    assert "done: loss" in out and "device=cpu" in out
    assert (tmp_path / "a" / "step_00000003").exists()
    assert len(hist) == 6
    hist2, out2 = _launch(tmp_path / "a", 8, 100, capsys)
    assert "restored checkpoint at step 6" in out2
    assert [h["step"] for h in hist2] == [6, 7]
    full, _ = _launch(tmp_path / "b", 8, 100, capsys)
    np.testing.assert_allclose([h["loss"] for h in hist + hist2],
                               [h["loss"] for h in full], rtol=1e-4)


def test_train_launcher_refuses_a_mesh(tmp_path):
    """One process cannot hold the production mesh: ``--mesh pod`` raises
    with the reference's message."""
    with pytest.raises(RuntimeError, match="need 256 devices .*have 1"):
        launch_train.main(["--device", "cpu", "--mesh", "pod",
                           "--ckpt-dir", str(tmp_path)])


def test_train_launcher_needs_a_card_or_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--ckpt-dir", str(tmp_path)])


# ----------------------------------------------------------- grad_compress
def test_quantize_int8_matches_reference():
    """One block, against the reference's eager and jitted calls: q bit
    for bit (round half to even; exact halves included), the scale within
    1e-6 of the eager call's and bit-equal to the compiled one's (XLA
    multiplies by 1/127 where the source divides), and dequantize."""
    rng = np.random.default_rng(7)
    for i in range(16):
        x = rng.normal(size=(3, 64)).astype(np.float32)
        x[0, :4] = [0.5, 1.5, -2.5, 127.0]
        jq, js = j_quantize_int8(jnp.asarray(x))
        cq, cs = jax.jit(j_quantize_int8)(jnp.asarray(x))
        q, s = quantize_int8(torch.from_numpy(x))
        assert q.dtype == torch.int8 and s.shape == ()
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(q.numpy(), np.asarray(cq))
        np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
        assert float(s) == float(cs)
        np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                      np.asarray(cq, np.float32) *
                                      np.float32(cs))


@pytest.fixture(scope="module")
def compress_ref(tmp_path_factory):
    """The reference's two error-feedback steps over 8 XLA host devices
    (tests/test_distributed.py::test_compressed_psum_error_feedback's
    recipe), each device's (q, scale), as one npz."""
    out = tmp_path_factory.mktemp("compress") / "ref.npz"
    _run(f"""
        import numpy as np, jax, jax.numpy as jnp
        from repro.optim.grad_compress import (make_compressed_allreduce,
                                               quantize_int8)
        mesh = jax.make_mesh((8,), ("data",))
        rng = np.random.default_rng(0)
        g_np = rng.normal(size=(8, 64)).astype(np.float32)
        fn = make_compressed_allreduce(mesh, ("data",))
        g = {{"w": jnp.asarray(g_np)}}
        out1, res1 = fn(g, {{"w": jnp.zeros((8, 64), jnp.float32)}})
        out2, res2 = fn(g, res1)
        qs = [quantize_int8(jnp.asarray(g_np[i:i + 1])) for i in range(8)]
        np.savez("{out}", g=g_np,
                 q=np.stack([np.asarray(q) for q, _ in qs]),
                 scale=np.asarray([float(s) for _, s in qs], np.float32),
                 out1=np.asarray(out1["w"]), res1=np.asarray(res1["w"]),
                 out2=np.asarray(out2["w"]), res2=np.asarray(res2["w"]))
        result = {{}}
    """, devices=8)
    return np.load(out)


def _stacked(g, sizes=(8,), names=("data",), axes=("data",)):
    fn = make_compressed_allreduce(make_mesh(sizes, names, device="cpu"),
                                   axes)
    tree = {"w": torch.from_numpy(g)}
    res = init_residual(tree)
    rows = {}
    for i in (1, 2):
        o, res = fn(tree, res)
        rows[f"out{i}"], rows[f"res{i}"] = o["w"].numpy(), res["w"].numpy()
    return rows


def test_compressed_allreduce_matches_reference(compress_ref):
    """The stacked form on the CPU against the reference's shard_map: each
    device's q bit for bit and scale within 1e-6, both steps' means within
    1e-6, the residuals equal; and the reference test's three properties:
    one step's error is bounded, the residual is live, and the two-step
    average is closer to the true mean."""
    ref = compress_ref
    g = ref["g"]
    for i in range(8):
        q, s = quantize_int8(torch.from_numpy(g[i:i + 1]))
        np.testing.assert_array_equal(q.numpy(), ref["q"][i])
        np.testing.assert_allclose(float(s), ref["scale"][i], rtol=1e-6)
    got = _stacked(g)
    for k in ("out1", "out2"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7)
    for k in ("res1", "res2"):
        np.testing.assert_array_equal(got[k], ref[k])
    true_mean = g.mean(0)
    err1 = np.abs(got["out1"][0] - true_mean).max()
    err2 = np.abs((got["out1"][0] + got["out2"][0]) / 2 - true_mean).max()
    assert err1 < 0.1
    assert np.abs(got["res1"]).max() > 0
    assert err2 < err1 * 0.75


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_compressed_allreduce_process_group_equals_stacked(compress_ref,
                                                           tmp_path):
    """The gloo form, 8 ranks each holding one device's row, on a 1-D mesh
    and on a (2, 4) mesh averaging over "data" alone and over both axes:
    every rank's rows equal the stacked form's bit for bit."""
    case = tmp_path / "case.npz"
    np.savez(case, g=compress_ref["g"])
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_compress_worker.py"),
         str(r), "8", str(port), str(tmp_path), str(case)],
        env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(8)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    for name, (sizes, names, axes) in MESHES.items():
        want = _stacked(compress_ref["g"], sizes, names, axes)
        for r in range(8):
            got = np.load(tmp_path / f"compress.rank{r}.npz")
            for k, rows in want.items():
                np.testing.assert_array_equal(got[f"{name}_{k}"],
                                              rows[r:r + 1])
