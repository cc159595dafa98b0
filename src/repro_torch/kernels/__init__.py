"""Compute kernels of the search path and of the vector store's load path:
a hand-written CUDA kernel per op (``csrc/``, built by ``build.py``) beside
its plain PyTorch version, chosen by ``dispatch`` from where the tensors
are."""
