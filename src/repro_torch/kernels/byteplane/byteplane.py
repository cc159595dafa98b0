"""XOR-delta byte-plane decode: ``[n, V]`` uint8 XOR a ``[V]`` uint8 base
vector -> ``[n, V]`` uint8, bit-exact (the inverse of the §3.3 seal's
XOR-delta, on the vector store's load path).

``byteplane_decode_cuda`` launches ``csrc/byteplane.cu`` (the port of
``repro/kernels/byteplane/byteplane.py::byteplane_decode_pallas``);
``byteplane_decode_ref`` is its plain PyTorch version (the reference's
``byteplane_decode_ref``). XOR is exact, so the two are bit-identical.
"""
import torch

from ..build import check_cuda, launch


def byteplane_decode_ref(packed: torch.Tensor,
                         base: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_xor(packed, base[None, :])


def byteplane_decode_cuda(packed: torch.Tensor,
                          base: torch.Tensor) -> torch.Tensor:
    if packed.dtype != torch.uint8 or base.dtype != torch.uint8:
        raise TypeError("byteplane_decode takes uint8 rows and a uint8 base")
    if packed.dim() != 2 or base.shape != (packed.shape[1],):
        raise ValueError(f"base {tuple(base.shape)} does not match rows "
                         f"{tuple(packed.shape)}")
    check_cuda(packed, base)
    out = torch.empty_like(packed)
    n, v = packed.shape
    if n * v:
        launch("byteplane", "byteplane_decode", packed, base, out, n, v)
    return out
