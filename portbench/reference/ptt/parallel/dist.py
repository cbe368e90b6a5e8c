"""The reference runs in one process: a global sum over the data-parallel
ranks is the local value (world size 1)."""


def global_sum(x):
    return x
