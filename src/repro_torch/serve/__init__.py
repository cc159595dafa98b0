"""The serving tier: batched, shard-fanned ANN search with the paper's I/O
model replayed per served batch (``ann.py``), the SLO-aware admission
queue that forms those batches from an open-loop request stream
(``admission.py``), the LM engine's prefill + decode loop (``engine.py``)
and retrieval-augmented generation over both (``rag.py``)."""
from . import admission, ann, engine, rag  # noqa: F401
from .admission import (AdmissionConfig, AdmissionQueue, Request,  # noqa: F401
                        TenantConfig)
from .ann import BatchedSearcher, BatchReport, ServeConfig  # noqa: F401
from .engine import ServeEngine  # noqa: F401
from .rag import RAGPipeline  # noqa: F401
