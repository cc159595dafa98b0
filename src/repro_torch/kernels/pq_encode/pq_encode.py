"""PQ encoding of device tensors: ``[n, D]`` uint8 or float32 vectors x
``[M, K, dsub]`` centroids -> ``[n, M]`` uint8 codes (per subspace the
first centroid at least squared distance, folded over dsub in order).

``pq_encode_cuda`` launches ``csrc/pq_encode.cu``, which has no TPU
counterpart: the reference encodes with numpy on the host
(``repro/core/graph/pq.py::encode_pq``), and so does this port's
``core/graph/pq.py::encode_pq``. ``pq_encode_ref`` is the kernel's plain
PyTorch version; for dsub < 8 it gives numpy's codes byte for byte. The
kernel takes any dsub: the widths in ``DSUBS`` are templates, any other
runs its generic path, which stages a block's inputs beside the
centroids (the launch fails where they pass a block's shared memory:
dsub > 113 at K = 256 on an H100).
"""
import torch

from ..build import check_cuda, launch

DSUBS = (1, 2, 3, 4, 8, 16)


def pq_encode_ref(vectors: torch.Tensor,
                  centroids: torch.Tensor) -> torch.Tensor:
    m, k, dsub = centroids.shape
    x = vectors.to(torch.float32)
    out = torch.empty((x.shape[0], m), dtype=torch.uint8, device=x.device)
    for mi in range(m):
        diff = x[:, None, mi * dsub:(mi + 1) * dsub] - centroids[mi][None]
        sq = diff * diff
        acc = sq[..., 0].clone()
        for s in range(1, dsub):
            acc += sq[..., s]
        out[:, mi] = acc.argmin(1).to(torch.uint8)
    return out


def pq_encode_cuda(vectors: torch.Tensor,
                   centroids: torch.Tensor) -> torch.Tensor:
    m, k, dsub = centroids.shape
    n, d = vectors.shape
    if d != m * dsub or dsub < 1 or k > 256:
        raise ValueError(f"pq_encode takes D = M*dsub, dsub >= 1 and "
                         f"K <= 256; got D={d}, centroids "
                         f"{tuple(centroids.shape)}")
    entry = {torch.uint8: "pq_encode_u8",
             torch.float32: "pq_encode_f32"}.get(vectors.dtype)
    if entry is None or centroids.dtype != torch.float32:
        raise TypeError("pq_encode takes uint8 or float32 vectors and "
                        "float32 centroids")
    dev = check_cuda(vectors, centroids)
    out = torch.empty((n, m), dtype=torch.uint8, device=dev)
    if n:
        launch("pq_encode", entry, vectors, centroids, out, n, m, k, dsub)
    return out
