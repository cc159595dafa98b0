"""The serving tier: batched, shard-fanned ANN search with the paper's I/O
model replayed per served batch (``ann.py``), and the SLO-aware admission
queue that forms those batches from an open-loop request stream
(``admission.py``)."""
from . import admission, ann  # noqa: F401
from .admission import (AdmissionConfig, AdmissionQueue, Request,  # noqa: F401
                        TenantConfig)
from .ann import BatchedSearcher, BatchReport, ServeConfig  # noqa: F401
