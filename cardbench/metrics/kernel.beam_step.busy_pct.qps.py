"""Share of the card's busy time in the traced stretch taken by kernels
named beam_step (%); moves qps."""


def read(run):
    t = run.traces.get("main")
    if t is None or t.busy_s <= 0:
        return None
    s = t.kernel_seconds("beam_step")
    return 100.0 * s / t.busy_s if s > 0 else None
