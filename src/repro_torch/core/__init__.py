"""DecoupleVS core on PyTorch: codecs, graph + PQ build, device index and
the batch-first beam search (paper §3.2-§3.4)."""
