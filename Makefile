# One-liners for the repo's tier-1 verification and benchmarks (README.md).
PY ?= python
export PYTHONPATH := src:$(PYTHONPATH)
export JAX_PLATFORMS ?= cpu

.PHONY: test test-fast test-torch test-reorder test-kernels test-serve test-sharded bench-smoke bench bench-kernels bench-update bench-storage bench-serve bench-search bench-shard bench-summary quickstart

test:            ## tier-1: full test suite, stop at first failure (~2.5 min)
	$(PY) -m pytest -x -q

test-fast:       ## tier-1 minus the slow interpret-mode sweeps
	$(PY) -m pytest -x -q -m "not slow"

test-torch:      ## PyTorch port parity tier vs the JAX reference (CPU; CUDA cases skip)
	$(PY) -m pytest -x -q tests/test_torch_*.py

test-reorder:    ## permutation-invariance property tier (both kernel backends)
	$(PY) -m pytest -x -q tests/test_reorder.py tests/test_codec_registry.py

test-kernels:    ## kernel conformance + backend-equivalence tier
	$(PY) -m pytest -x -q tests/test_kernel_conformance.py tests/test_kernels.py tests/test_search.py

test-serve:      ## admission/serving tier: simulated-clock properties + hot swap + quota floors
	$(PY) -m pytest -x -q tests/test_admission.py tests/test_serve_ann.py tests/test_snapshot.py tests/test_codec_registry.py

test-sharded:    ## mesh-scale sharding tier: 8/16/32-device merges + routing + hot swap
	$(PY) -m pytest -x -q tests/test_sharded.py

bench-kernels:   ## ref-vs-pallas-vs-auto-tuned per op + e2e -> BENCH_kernels.json (+ autotune cache)
	$(PY) -m benchmarks.bench_kernels

bench-summary:   ## fold all BENCH_*.json into a BENCH_summary.json trajectory row
	$(PY) -m benchmarks.run --summary

bench-update:    ## streaming-update arms (inc/full/colocated) -> BENCH_update.json
	$(PY) -m benchmarks.bench_update

bench-storage:   ## planner vs fixed-codec vs colocated space savings -> BENCH_storage.json
	$(PY) -m benchmarks.bench_storage

bench-serve:     ## admission-tier SLO tails (Poisson vs bursty) -> BENCH_serve.json
	$(PY) -m benchmarks.bench_serve

bench-search:    ## blocking vs pipelined vs coresident pipeline arms -> BENCH_search.json
	$(PY) -m benchmarks.bench_search --smoke

bench-shard:     ## QPS-vs-shards scaling + routing + failed-shard arms -> BENCH_shard.json
	$(PY) -m benchmarks.bench_shard

bench-smoke:     ## ~30 s serving-path benchmark (QPS vs batch x shards)
	$(PY) -m benchmarks.bench_serve_ann --smoke

bench:           ## full benchmark harness (one row per paper table/figure)
	$(PY) -m benchmarks.run

quickstart:      ## build an index, measure storage savings, search
	$(PY) examples/quickstart.py
