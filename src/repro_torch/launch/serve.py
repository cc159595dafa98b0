"""Serving launcher: mesh + batched prefill/decode engine (+ optional RAG).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --requests 8 --max-new 16 [--rag] [--device cpu] [--mesh local]

Runs on the CUDA card unless ``--device`` names another device; without a
card and without ``--device`` it raises. ``--mesh`` is the training
launcher's: ``local`` (the process group's world; one device without a
group) or the production ``pod``/``multipod`` meshes, which need a group
of 256 or 512 ranks. Times are host-clock walls around work that ends in
a device synchronise, printed with the device's name.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, reduce_config
from ..data.synthetic import make_token_batch
from ..kernels.dispatch import resolve_device
from ..models import sharding
from ..models.api import Model
from ..serve.engine import ServeEngine


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else \
        str(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--mesh", default="local",
                    choices=["local", "pod", "multipod"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--rag", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.preset == "full" \
        else reduce_config(get_config(args.arch))
    from .train import build_mesh
    mesh = build_mesh(args.mesh, dev)
    model = Model.from_config(cfg)
    with sharding.policy(mesh, None):
        return _serve(args, cfg, model, dev)


def _serve(args, cfg, model, dev):
    params = model.init(0, device=dev, shardings=model.param_shardings())
    engine = ServeEngine(model, params, device=dev)
    prompts = make_token_batch(cfg.vocab, args.requests, args.prompt_len)
    stats = None
    if cfg.encoder_layers:
        frames = np.random.default_rng(0).normal(
            size=(args.requests, args.prompt_len, cfg.frontend_dim)
        ).astype(np.float32)
        t0 = time.perf_counter()
        out = engine.generate(prompts[:, :8], max_new=args.max_new,
                              frontend=frames)
    elif args.rag:
        from ..serve.rag import RAGPipeline
        docs = make_token_batch(cfg.vocab, 256, 12, seed=3)
        rag = RAGPipeline(engine, doc_tokens=docs, k=2)
        t0 = time.perf_counter()
        out, stats = rag.answer(prompts, max_new=args.max_new)
        print(f"retrieval: {stats['graph_ios']} graph + "
              f"{stats['vector_ios']} vector block reads")
    else:
        t0 = time.perf_counter()
        out = engine.generate(prompts, max_new=args.max_new)
    dt = time.perf_counter() - t0       # generate ends in a copy to the host
    tok = args.requests * args.max_new
    print(f"{cfg.name}: {args.requests} requests x {args.max_new} new tokens "
          f"in {dt:.2f}s ({tok / dt:.1f} tok/s, eager, on "
          f"{device_name(dev)})")
    print("sample:", np.asarray(out)[0][:10].tolist())
    return out, stats


if __name__ == "__main__":
    main()
