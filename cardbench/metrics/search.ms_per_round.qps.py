"""Wall of the bare search of a 1,024-query batch over its traversal rounds
(ms); moves qps."""
from cardbench import readers


def read(run):
    return readers.ms_per_round(run)
