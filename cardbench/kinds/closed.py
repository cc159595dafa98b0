"""Kind ``closed``: one caller at a time sends ``batch`` consecutive
queries of the pool (wrapping round) through ``BatchedSearcher.search``
and waits for the answer.

Mix keys: ``batch``; ``buckets`` and ``account_io`` (the serve tier's
``ServeConfig``); ``check_batches``, the served batches the check draws.

The cell sets the program up on the inputs (``setup``), drives it for the
window (``window``), records its layers on a short traced stretch
(``stretch``, ``--trace 1`` only), lets the program's state go
(``release``) and holds what the window produced against the plain
reference (``check``).
"""
from __future__ import annotations

import time

import numpy as np

from cardbench.frozen import bounds, shard
from cardbench.record import profile
from cardbench.reference import search as ref
from cardbench.world import subseed

#: Rows of queries the reference searches at a time.
REF_ROWS = 1024


def batches(mix: dict, pool: int):
    """Endless [batch] index arrays of consecutive pool rows."""
    start = 0
    while True:
        yield (start + np.arange(mix["batch"])) % pool
        start = (start + mix["batch"]) % pool


class Cell:
    """Batches of queries through ``BatchedSearcher.search``."""

    def __init__(self, torch, prog, cfg, mix, world, seed, device, run,
                 trace):
        self.torch, self.prog, self.cfg, self.mix = torch, prog, cfg, mix
        self.world, self.seed, self.device = world, seed, device
        self.run, self.trace = run, trace
        self.pool = world.queries
        self.served = []          # (pool rows, ids, dists) a batch

    # ------------------------------------------------------------ set-up
    def setup(self):
        torch, prog, cfg, w = self.torch, self.prog, self.cfg, self.world
        p = shard.search_params(prog, cfg)._replace(
            max_rerank_batches=cfg["max_rerank_batches"],
            benefit_threshold=cfg["benefit_threshold"])
        self.index = shard.device_index(
            torch, prog, w.vectors.clone(), w.graph, w.centroids, w.medoid,
            cfg["r"])
        elt = w.vectors.element_size()
        cache = int(cfg["cache_ratio"] * cfg["n_vectors"] * cfg["dim"] * elt)

        self.searcher = prog.BatchedSearcher(self.index, p, prog.ServeConfig(
            buckets=tuple(self.mix["buckets"]),
            account_io=self.mix["account_io"], cache_bytes=cache),
            device=self.device)
        self.searcher.search(
            self.pool[np.arange(self.mix["batch"]) % len(self.pool)])

    # ------------------------------------------------------------ window
    def _serve(self, rows):
        ids, dists, rep = self.searcher.search(self.pool[rows])
        self.run.count("queries", rep.n_queries)
        self.run.count("batches", 1)
        self.run.spans.setdefault("serve.batch", []).append(rep.wall_s)
        self.served.append((rows, ids, dists))

    def window(self, seconds: float) -> dict:
        gen = batches(self.mix, len(self.pool))
        done, t0 = 0, time.perf_counter()
        while True:
            rows = next(gen)
            self._serve(rows)
            done += len(rows)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"qps": done / elapsed, "attempted": done}

    # ----------------------------------------------------------- stretch
    def stretch(self):
        torch, prog, run = self.torch, self.prog, self.run
        recent = [rows for rows, _, _ in self.served[-4:]]
        cfg, p = self.cfg, self.searcher.p
        m, k = cfg["pq_m"], cfg["pq_k"]
        elt = self.world.vectors.element_size()
        words = bounds.ef_slot_words(cfg["r"], cfg["n_vectors"])
        last = None
        for rows in recent:
            q = torch.from_numpy(self.pool[rows]).to(self.device)
            with run.span(torch, "search.wall"):
                _, _, st = prog.search(self.index, q, p, self.device)
            it = st.iters.long()
            nq = len(rows)
            run.count("search.rounds", int(it.max()))
            run.count("search.bytes", (
                int(st.lists_fetched.sum()) * words * 4
                + int(st.pq_dists.sum()) * m + nq * m * k * 4
                + int(st.exact_dists.sum()) * cfg["dim"] * elt
                + nq * cfg["dim"] * 4 + nq * cfg["k"] * 8))
            last = (q, it, st)
        # the last batch's hops: one launch a round over every row; a row
        # is active (reads its LUT) in each of its own rounds, and scores
        # every new id but its entry
        q, it, st = last
        nq, e = q.shape[0], cfg["beam_width"] * cfg["r"]
        valid = int(st.pq_dists.sum()) - nq
        hop = bounds.beam_step_bytes(0, nq, m, k, cfg["l_size"], e,
                                     lut_rows=0)
        run.counters["beam_step.bytes"] = int(it.max()) * hop \
            + bounds.beam_step_bytes(valid, 0, m, k, cfg["l_size"], e,
                                     lut_rows=int(it.sum()))
        run.traces["search"] = profile(
            torch, lambda: prog.search(self.index, q, p, self.device),
            run.sync)

        def served():
            for r in recent[-2:]:
                with run.label(torch, "serve.search"):
                    self.searcher.search(self.pool[r])
        run.traces["main"] = profile(torch, served, run.sync)

    # ------------------------------------------------------------- check
    def release(self):
        self.searcher = self.index = None

    def check(self, seed: int) -> dict:
        """Rows of a sample of the window's answers that differ, ids or
        distances, from the reference's answers to the same queries."""
        rows, ids, dists = self.sample(seed)
        want = self.reference(rows, self.torch.float32)
        walls = np.asarray(self.run.spans["serve.batch"])
        return {"rows_wrong": (_rows_wrong((ids, dists), want), 0),
                "_rows_checked": len(rows),
                "_batch_wall_s": [round(float(x), 4) for x in np.percentile(
                    walls, [0, 25, 50, 75, 100])]}

    def control(self, seed: int, dtype) -> dict:
        """The check's numbers with the reference at ``dtype`` put in the
        program's place."""
        rows, _, _ = self.sample(seed)
        low = self.reference(rows, dtype)
        want = self.reference(rows, self.torch.float32)
        return {"rows_wrong": (_rows_wrong(low, want), 0),
                "_rows_checked": len(rows)}

    def sample(self, seed: int):
        """``check_batches`` whole served batches, drawn from the seed."""
        rng = np.random.default_rng(subseed(seed, "check"))
        pick = rng.choice(len(self.served),
                          min(len(self.served), self.mix["check_batches"]),
                          replace=False)
        chosen = [self.served[i] for i in sorted(pick)]
        return tuple(np.concatenate(x) for x in zip(*chosen))

    def reference(self, rows, dtype):
        """The reference's (ids, dists) for pool rows ``rows``."""
        torch, w, cfg = self.torch, self.world, self.cfg
        codes = ref.Codes(w.vectors, w.centroids, dtype)
        out_i, out_d = [], []
        for a in range(0, len(rows), REF_ROWS):
            q = torch.from_numpy(self.pool[rows[a:a + REF_ROWS]]).to(
                self.device)
            i, d, _ = ref.search(w.vectors, w.graph, w.centroids, w.medoid,
                                 q, cfg, dtype, codes)
            out_i.append(i.cpu().numpy())
            out_d.append(d.cpu().numpy())
        return np.concatenate(out_i), np.concatenate(out_d)


def _rows_wrong(got, want) -> int:
    """Rows whose ids or distances (bit for bit) differ."""
    (gi, gd), (wi, wd) = got, want
    return int(((gi != wi).any(1)
                | (gd.view(np.int32) != wd.view(np.int32)).any(1)).sum())
