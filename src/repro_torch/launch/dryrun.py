"""Multi-pod dry-run: trace every (arch x input-shape x mesh) cell on
``meta`` tensors under a fake process group, with no device and no
allocation.

The process joins a ``fake`` process group of 512 ranks
(``torch.testing._internal.distributed.fake_pg``) as rank 0 and builds the
production mesh over it (``launch/mesh.py``). Every param, optimizer leaf,
batch and cache is a DTensor of ``meta`` local shards, placed by the
sharding policy (``_rules_for``). Each cell runs its full program once:

  train    make_train_step: forward + backward + AdamW (remat "full",
           ``LOSS_CHUNK`` 256, 8 microbatches where the batch splits)
  prefill  Model.prefill (flash attention)
  decode   one Model.decode_step against a seq_len cache

and counts, for rank 0, the local ops DTensor runs on its shards
(:class:`LocalCost`):

  flops     FlopCounterMode's formula table (``torch.utils.flop_counter``:
            matmuls, convolutions, attention) over each local op: the
            rank's own FLOPs, not the logical ones FlopCounterMode counts
            over DTensors. Split by layer (``by_scope``): the model's layer
            functions (``transformer._apply_layer``, ``encdec.encode`` /
            ``decode_train`` / ``decode_step``) and ``adamw_update``, in
            forward and, through the autograd node that runs it, in
            backward; the rest is the stem.
  bytes     bytes accessed: the sum over local ops of each tensor input's
            and each tensor output's bytes, a view's (no data moved) and
            an ``empty``'s excepted; a gather's source counts as many bytes
            as it returns.
  coll      each collective by kind with its bytes (all-gather: the
            gathered output; reduce-scatter, all-reduce, all-to-all: the
            input), counted by ``CommDebugMode`` (``coll_counts``).
  peak      the most local bytes live at once (inputs included).
  trace_s   the trace's wall on the host.

There is no ``compile_s``: nothing is compiled. The roofline terms
(``launch/roofline.py``) take the H100's datasheet rates; a caller with
measured rates recomputes them from the counts.

``--arch decouplevs-ann`` runs the paper's own workload instead:
``lower_production_search`` (core/distributed/sharded_index.py), a
shape-only pass over the index shards.

Results are written incrementally to JSON (one file per cell) so a long
sweep can be resumed/killed safely.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch decouplevs-ann --both-meshes
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-cost]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
import weakref
from collections import defaultdict
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.overrides import TorchFunctionMode

from ..configs import ARCHS, SHAPES, applicable, get_config
from ..models import sharding
from ..models.api import Model
from ..models.schema import tree_map
from ..optim.adamw import AdamWConfig, abstract_opt_state
from ..train.trainer import TrainConfig, make_train_step, place_batch
from . import roofline
from .mesh import dp_size, make_production_mesh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
FAKE_WORLD = 512
ANN_ARCH = "decouplevs-ann"

# Big-vocab models must never materialise [B, S, V] logits in training.
LOSS_CHUNK = 256


def init_fake_world(world: int = FAKE_WORLD) -> None:
    """Join a ``fake`` process group of ``world`` ranks as rank 0 (once a
    process): collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)


def _rules_for(cfg, shape, mesh):
    """Long-context cells (batch < DP) shard sequence instead of batch;
    archs whose kv-head count does not divide the TP axis replicate KV
    projections (Megatron GQA practice) instead of splitting head_dim."""
    long_ctx = shape.global_batch < dp_size(mesh)
    rules = dict(sharding.LONG_CONTEXT_RULES) if long_ctx \
        else dict(sharding.DEFAULT_RULES)
    model = sharding.axis_sizes(mesh)["model"]
    kv_div = cfg.n_kv_heads and cfg.n_kv_heads % model == 0
    if cfg.n_kv_heads and not kv_div:
        rules["kv_heads"] = None
        rules["kv_seq"] = ("pod", "data", "model") if long_ctx else "model"
    if shape.kind == "decode":
        # dense weights fit when sharded over `model` only: replicate over
        # data (no per-token ZeRO all-gather)
        rules["embed"] = None
    elif long_ctx:
        rules["kv_seq"] = ("pod", "data")
    return rules


_CACHE_AXES = {
    "k": (None, "batch", "kv_seq", "kv_heads", "kv_hd"),
    "v": (None, "batch", "kv_seq", "kv_heads", "kv_hd"),
    "xk": (None, "batch", "kv_seq", "kv_heads", "kv_hd"),
    "xv": (None, "batch", "kv_seq", "kv_heads", "kv_hd"),
    "conv": (None, "batch", None, "ffn"),
    "h": (None, "batch", "ffn", None),
    "x_prev": (None, "batch", None),
    "x_prev_cm": (None, "batch", None),
    "s": (None, "batch", "heads", None, None),
}


def _place(t, *axes):
    return sharding.distribute(t, sharding.sharding_for_shape(t.shape, *axes))


def _place_cache(cache):
    return {k: (_place(v, *_CACHE_AXES[k][-v.dim():]) if k in _CACHE_AXES
                else _place_cache(v)) for k, v in cache.items()}


# ------------------------------------------------------------- the counter
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "broadcast"}
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided"}
_GATHERS = {"index", "embedding", "gather", "index_select"}
_SCOPE = "dryrun_scope"


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t) -> int:
    # an expanded tensor reads its storage once; a slice its own elements
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class LocalCost(TorchDispatchMode):
    """Counts the local ops of the running rank (see the module's
    docstring). DTensor-level calls pass through (``NotImplemented``), so
    DTensor runs them and this mode sees the ops it issues on the local
    shards; the fake tensors of DTensor's sharding propagation are not
    counted."""

    def __init__(self, base_bytes: int = 0, stored=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = defaultdict(float)
        self.coll_counts = defaultdict(int)
        self.by_scope = defaultdict(lambda: {"flops": 0.0, "bytes": 0.0})
        self.scopes = []
        self.live = self.peak = base_bytes
        self._held = {id(t.untyped_storage()) for t in stored}

    def scope(self) -> str:
        if self.scopes:
            return self.scopes[-1]
        node = torch._C._current_autograd_node()
        if node is not None:
            return node.metadata.get(_SCOPE, "stem")
        return "stem"

    def _hold(self, t) -> None:
        st = t.untyped_storage()
        if id(st) in self._held:
            return
        n = st.nbytes()
        self._held.add(id(st))
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, id(st), n)

    def _free(self, key, n) -> None:
        self._held.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
        from torch.utils._python_dispatch import \
            _get_current_dispatch_mode_stack
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(m, FakeTensorMode)
                for m in _get_current_dispatch_mode_stack()):
            return out                  # DTensor's sharding propagation
        name = func._overloadpacket.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        scope = self.by_scope[self.scope()]
        if name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            n = sum(map(_nbytes, outs if kind == "all-gather" else ins))
            self.coll[kind] += n
            self.coll_counts[kind] += 1
        elif not func.is_view and name not in _NO_BYTES:
            if name in _GATHERS and ins:
                src = min(_nbytes(ins[0]), sum(map(_nbytes, outs)))
                n = src + sum(map(_nbytes, ins[1:])) + sum(map(_nbytes, outs))
            else:
                n = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.bytes += n
            scope["bytes"] += n
        fn = self.flop_registry.get(func._overloadpacket)
        if fn is not None:
            f = float(fn(*args, **kwargs, out_val=out))
            self.flops += f
            scope["flops"] += f
        for t in outs:
            self._hold(t)
        return out


class _TagScopes(TorchFunctionMode):
    """Tags each autograd node with the scope it was made in ("stem"
    outside any), so the backward ops the node runs count toward the same
    layer. A composite op makes nodes behind its output's: the walk tags
    every node not tagged yet."""

    def __init__(self, cost: LocalCost):
        super().__init__()
        self.cost = cost

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        scope = self.cost.scopes[-1] if self.cost.scopes else "stem"
        todo = [t.grad_fn for t in _tensors(out)]
        while todo:
            node = todo.pop()
            if node is None or _SCOPE in node.metadata:
                continue
            node.metadata[_SCOPE] = scope
            todo.extend(n for n, _ in node.next_functions)
        return out


def _layer_name(desc) -> str:
    return f"layer:{desc.mixer}/{desc.mlp}{'/w' if desc.window else ''}"


@contextlib.contextmanager
def _scoped(cost: LocalCost):
    """The model's layer functions and the optimizer update run inside a
    named scope of ``cost`` while the trace runs (restored after)."""
    from ..models import encdec, transformer
    from ..train import trainer
    named = [(transformer, "_apply_layer", lambda a: _layer_name(a[0])),
             (encdec, "encode", lambda a: "layer:enc"),
             (encdec, "decode_train", lambda a: "layer:dec"),
             (encdec, "decode_step", lambda a: "layer:dec"),
             (trainer, "adamw_update", lambda a: "optimizer")]
    saved = []

    def wrap(fn, name_of):
        def run(*a, **k):
            cost.scopes.append(name_of(a))
            try:
                return fn(*a, **k)
            finally:
                cost.scopes.pop()
        return run

    try:
        for mod, attr, name_of in named:
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, wrap(fn, name_of))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


# ------------------------------------------------------------- full programs
def _train_tcfg(model, shape, mesh) -> TrainConfig:
    cfg = model.cfg
    np_ = cfg.n_periods if not cfg.encoder_layers else 1
    group = max((d for d in range(1, int(np_ ** 0.5) + 1) if np_ % d == 0),
                default=1)
    # 8 microbatches (grad accumulation) where each one's rows split
    # over the data-parallel ranks
    mb = 8 if shape.global_batch % (8 * dp_size(mesh)) == 0 else 1
    return TrainConfig(remat="full", attn_mode="dense", ssm_mode="chunk",
                       loss_chunk=LOSS_CHUNK, remat_group=group,
                       microbatches=mb)


def _program(model: Model, shape, tcfg):
    """(inputs, run): the cell's placed meta inputs and its program."""
    cfg = model.cfg
    params = tree_map(lambda t, s: sharding.distribute(t, s),
                      model.abstract_params(), model.param_shardings())
    if shape.kind == "train":
        opt = abstract_opt_state(model.abstract_params())
        opt = {k: (tree_map(lambda t, s: sharding.distribute(t, s),
                            opt[k], model.param_shardings())
                   if k != "step" else _place(opt[k]))
               for k in opt}
        # the step splits the full batch into microbatches and places each
        batch = model.input_specs(shape)
        step = make_train_step(model, AdamWConfig(), tcfg)
        return (params, opt, place_batch(batch)), \
            lambda: step(params, opt, batch)
    if shape.kind == "prefill":
        batch = place_batch(model.input_specs(shape, for_loss=False))
        return (params, batch), lambda: model.prefill(
            params, batch, attn_mode="flash", ssm_mode="chunk")
    b = shape.global_batch
    s_enc = 4096 if cfg.encoder_layers else 0
    cache = _place_cache(model.abstract_cache(b, shape.seq_len, s_enc=s_enc))
    tok = _place(torch.empty((b, 1), dtype=torch.int64, device="meta"),
                 "batch", None)
    pos = _place(torch.empty((b,), dtype=torch.int64, device="meta"),
                 "batch")
    return (params, cache, tok, pos), lambda: model.decode_step(
        params, cache, tok, pos)


def trace_program(model: Model, shape, mesh, rules, tcfg=None) -> dict:
    """Trace one cell's program on ``mesh`` under ``rules`` (train: under
    ``tcfg``, default the production one) and return rank 0's counts."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    with sharding.policy(mesh, rules):
        if shape.kind == "train":
            tcfg = tcfg or _train_tcfg(model, shape, mesh)
        inputs, run = _program(model, shape, tcfg)
        leaves = [t.to_local() for t in _tensors(inputs)
                  if sharding.is_dtensor(t)]
        cost = LocalCost(sum(t.numel() * t.element_size() for t in leaves),
                         leaves)
        comm = CommDebugMode()
        t0 = time.perf_counter()
        with torch.no_grad() if shape.kind != "train" else \
                contextlib.nullcontext(), implicit_replication(), \
                _scoped(cost), comm, cost, _TagScopes(cost):
            out = run()
        trace_s = time.perf_counter() - t0
        del out
    counts = {str(op).split(".")[-1]: n
              for op, n in comm.get_comm_counts().items()}
    return {"flops": cost.flops, "bytes": cost.bytes,
            "coll_breakdown": dict(cost.coll),
            "coll_counts": dict(cost.coll_counts),
            "comm_debug_counts": counts,
            "peak_bytes": cost.peak,
            "by_scope": {k: dict(v) for k, v in sorted(cost.by_scope.items())},
            "trace_s": trace_s,
            "microbatches": tcfg.microbatches if tcfg else None}


def terms_of(counts: dict, rates=roofline.H100_DATASHEET):
    return roofline.RooflineTerms(
        flops=counts["flops"], bytes_accessed=counts["bytes"],
        coll_bytes=sum(counts["coll_breakdown"].values()),
        coll_breakdown=dict(counts["coll_breakdown"]),
        peak_memory_bytes=counts["peak_bytes"], rates=rates)


def optimizer_analytic_terms(n_params: float) -> roofline.RooflineTerms:
    """AdamW update: ~15 flops/param; bytes = read g(4)+m(4)+v(4)+master(4)
    + write m(4)+v(4)+master(4)+param(2) = 30 B/param (per device: /chips
    handled by caller via sharded param count)."""
    return roofline.RooflineTerms(flops=15.0 * n_params,
                                  bytes_accessed=30.0 * n_params,
                                  coll_bytes=0.0)


# ------------------------------------------------------------------- cells
def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_ann_cell(multi_pod: bool = False) -> dict:
    from ..configs.decouplevs_ann import CONFIG
    from ..core.distributed.sharded_index import lower_production_search
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    t0 = time.perf_counter()
    out = lower_production_search(mesh, CONFIG)
    out["trace_s"] = time.perf_counter() - t0
    return out


def lm_cell(model: Model, shape, mesh, rules, *, tcfg=None,
            with_cost: bool = True) -> dict:
    """One LM cell traced on ``mesh`` (see ``trace_program``): rank 0's
    counts, their roofline terms at the datasheet rates and, with
    ``with_cost``, the model-FLOPs terms the reference reports."""
    counts = trace_program(model, shape, mesh, rules, tcfg)
    cell = {"trace_s": round(counts.pop("trace_s"), 1), "counts": counts,
            "memory": {"peak_gib": counts["peak_bytes"] / 2**30}}
    total = terms_of(counts)
    cell["full_program"] = total.as_dict()
    if with_cost:
        n_dev = math.prod(mesh.shape)
        if shape.kind == "train":
            opt = optimizer_analytic_terms(model.n_params() / n_dev)
            cell["optimizer_analytic"] = opt.as_dict()
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                       else 1)
        mf = roofline.model_flops(roofline.active_params(model), tokens,
                                  shape.kind)
        cell["model_flops_per_device"] = mf / n_dev
        cell["roofline"] = total.as_dict()
        cell["roofline"]["model_flops_ratio"] = (
            mf / n_dev / total.flops if total.flops else 0.0)
        cell["roofline"]["roofline_fraction"] = total.roofline_fraction(
            mf / n_dev)
        cell["roofline"]["step_time_s"] = total.step_time_s
    return cell


def write_cell(cell: dict, out_dir) -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = out_dir / f"{cell['arch']}__{cell['shape']}__{cell['mesh']}.json"
    fname.write_text(json.dumps(cell, indent=1))
    return fname


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             with_cost: bool = True, out_dir: Path = RESULTS_DIR) -> dict:
    init_fake_world()
    mesh_name = _mesh_name(multi_pod)
    if arch == ANN_ARCH:
        cell = {"arch": arch, "shape": "search", "mesh": mesh_name,
                "skipped": False, "why_skipped": "",
                **run_ann_cell(multi_pod)}
        write_cell(cell, out_dir)
        return cell
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    ok, why = applicable(cfg, shape)
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "skipped": not ok, "why_skipped": why}
    if ok:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        cell.update(lm_cell(Model.from_config(cfg), shape, mesh,
                            _rules_for(cfg, shape, mesh),
                            with_cost=with_cost))
    write_cell(cell, out_dir)
    return cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-cost", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in SHAPES:
                cells.append((arch, shape))
        cells.append((ANN_ARCH, "search"))
    else:
        cells.append((args.arch, "search" if args.arch == ANN_ARCH
                      else args.shape))

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failed = 0
    for arch, shape in cells:
        for mp in meshes:
            key = f"{arch}/{shape}/{'multi' if mp else 'single'}"
            fname = out_dir / f"{arch}__{shape}__{_mesh_name(mp)}.json"
            if fname.exists():
                print(f"[skip-done] {key}", flush=True)
                continue
            try:
                t0 = time.time()
                cell = run_cell(arch, shape, multi_pod=mp,
                                with_cost=not args.skip_cost,
                                out_dir=out_dir)
                if cell["skipped"]:
                    status = "SKIP " + cell["why_skipped"]
                elif arch == ANN_ARCH:
                    status = (f"ok per-rank {cell['total_bytes'] / 1e9:.3f} "
                              f"GB, merge {cell['merge_comm_rows']} rows")
                else:
                    status = (f"ok trace={cell['trace_s']}s peak="
                              f"{cell['memory']['peak_gib']:.1f}GiB")
                print(f"[{time.time()-t0:6.1f}s] {key}: {status}", flush=True)
            except Exception as e:      # one cell's fault; the sweep goes on
                failed += 1
                print(f"[FAIL] {key}: {e}", flush=True)
                traceback.print_exc()
                out_dir.mkdir(parents=True, exist_ok=True)
                with (out_dir / "failures.log").open("a") as f:
                    f.write(f"{key}: {e}\n{traceback.format_exc()}\n")
    return failed


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
