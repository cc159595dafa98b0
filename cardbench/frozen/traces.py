"""Open-loop arrival generators, frozen.

Copied from ``src/repro_torch/serve/admission.py``: ``poisson_trace``
(lines 512-525) and ``bursty_trace`` (lines 528-570), at the commit that
added this benchmark. Only the arrival times are kept: the copies return
them as a float64 array in microseconds and leave out the tenant draw and
the ``Request`` assembly, which the benchmark does not use. The draws are
the originals' draws, in the same order, so a seed gives the same times.
"""
from __future__ import annotations

import numpy as np


def poisson_arrivals_us(rate_qps: float, n: int, seed: int,
                        start_us: float = 0.0) -> np.ndarray:
    """Poisson arrivals at ``rate_qps`` (exponential gaps) -> [n] us."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1e6 / rate_qps, size=n)
    return start_us + np.cumsum(gaps)


def bursty_arrivals_us(rate_qps: float, n: int, seed: int,
                       burst_factor: float = 8.0, duty: float = 0.2,
                       period_us: float = 20e3,
                       start_us: float = 0.0) -> np.ndarray:
    """On/off arrivals with the mean rate of :func:`poisson_arrivals_us`:
    a fraction ``duty`` of each ``period_us`` runs at ``burst_factor`` x
    the ON-share rate, the rest carries the remainder -> [n] us."""
    if not 0.0 < duty < 1.0:
        raise ValueError(f"duty must be in (0, 1), got {duty}")
    rng = np.random.default_rng(seed)
    on_share = min(1.0, duty * burst_factor)
    on_rate = rate_qps * on_share / duty
    off_rate = rate_qps * (1.0 - on_share) / (1.0 - duty)
    arrivals = []
    t = start_us
    while len(arrivals) < n:
        phase_on = ((t - start_us) % period_us) < duty * period_us
        rate = on_rate if phase_on else off_rate
        if rate <= 0.0:       # jump to the next phase boundary
            k = (t - start_us) // period_us
            t = start_us + ((k + duty) if phase_on else (k + 1.0)) * period_us
            continue
        gap = float(rng.exponential(1e6 / rate))
        # a gap crossing the phase boundary re-draws from the boundary
        phase_end = start_us + (
            ((t - start_us) // period_us)
            + (duty if phase_on else 1.0)) * period_us
        if t + gap > phase_end:
            t = phase_end
            continue
        t += gap
        arrivals.append(t)
    return np.asarray(arrivals)
