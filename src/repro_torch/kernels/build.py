"""Build, load and launch the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under
``<repo>/build/kernels/`` (listed in ``.gitignore``), named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags: a library is
rebuilt exactly when one of them changes. All missing libraries are
compiled at once, one ``nvcc`` process per source, at the first launch (or
by ``build_all``). Nothing is built when this module is imported, so the
CPU tests import it freely.

Every C entry point takes pointers and the stream as ``void*`` and returns
``cudaGetLastError()`` after its launch; ``launch`` raises on a non-zero
code. Kernels launch on ``torch.cuda.current_stream()``, allocate nothing,
and each kernel has a plain-int launch counter in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("pq_adc_batched", "ef_decode", "beam_step", "rerank_l2",
           "pq_encode", "byteplane", "pq_adc", "huffman_decode",
           "ef_record_decode", "round_expand", "round_settle",
           "rerank_loop")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# Launches per kernel name, incremented by ``launch`` only.
LAUNCHES: dict[str, int] = dict.fromkeys(SOURCES, 0)

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def library_path(name: str) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel library that is missing, all ``nvcc`` processes
    started together; raise with the compiler's output if one fails."""
    paths = {name: library_path(name) for name in SOURCES}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"--- nvcc {name}.cu (exit {proc.returncode})"
                          f"\n{out}")
        else:
            os.replace(tmp, todo[name])
            (BUILD_DIR / f"{name}.ptxas.txt").write_text(out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build_all()[name]))
    return lib


@functools.lru_cache(maxsize=None)
def _entry(name: str, entry: str, pointers: tuple[bool, ...]):
    """C entry point with its signature: per argument a pointer
    (``c_void_p``) or a ``long long``, then the stream; returns ``int``."""
    fn = getattr(library(name), entry)
    fn.argtypes = [ctypes.c_void_p if p else ctypes.c_longlong
                   for p in pointers] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def query(name: str, entry: str, *args: int) -> int:
    """Call C entry ``entry`` of kernel library ``name``, which takes
    ``long long`` arguments and no stream and returns a ``long long``."""
    fn = getattr(library(name), entry)
    fn.argtypes = [ctypes.c_longlong] * len(args)
    fn.restype = ctypes.c_longlong
    return int(fn(*args))


def launch(name: str, entry: str, *args) -> None:
    """Call C entry ``entry`` of kernel library ``name`` with ``args``
    (tensors pass their data pointer, ``None`` a null pointer, ints pass as
    C ``long long``) on the current stream; raise on a CUDA error; count
    the launch."""
    pointers = tuple(a is None or isinstance(a, torch.Tensor) for a in args)
    cargs = [None if a is None else a.data_ptr() if p else int(a)
             for a, p in zip(args, pointers)]
    rc = _entry(name, entry, pointers)(
        *cargs, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"CUDA kernel {name}/{entry} failed: "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1


def check_cuda(*tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device and contiguous, or raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"CUDA kernel inputs must share one CUDA "
                             f"device; got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("CUDA kernel inputs must be contiguous")
    return dev
