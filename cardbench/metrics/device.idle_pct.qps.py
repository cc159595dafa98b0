"""Share of the traced stretch with no kernel, copy or fill on the card
(%); moves the cell's end-to-end metric."""
from cardbench import readers


def read(run):
    return readers.idle_pct(run)
