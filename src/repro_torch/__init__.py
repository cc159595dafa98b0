"""DecoupleVS on PyTorch + CUDA (NVIDIA Hopper): the port of ``repro``.

The JAX package ``repro`` is the reference; this package mirrors its module
tree (``core/index.py``, ``core/search/beam.py``, ``core/storage/``,
``core/codec/``, ``kernels/<op>/``, ``kernels/dispatch.py``) so each
function has a counterpart under the same path. It imports ``torch`` and
never ``jax`` or ``repro``.

Entry points (``core.index.build_device_index``, ``core.search.beam.search``
and friends, the stores of ``core.storage``) run on the CUDA device unless
the caller passes ``device="cpu"``; with no card and no device they raise.
Every compute op that a ``pallas_call`` carries in the reference is a
hand-written CUDA kernel for ``sm_90a`` (``kernels/csrc``) on a CUDA
tensor, and its plain PyTorch version on a CPU tensor — never a fallback
from one to the other.
"""
