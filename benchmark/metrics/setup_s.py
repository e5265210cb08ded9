"""Seconds from the process's start to the window's: imports, the kernels'
build (cached in the checkout after a cell's first run), the state made
from the seed, and the warm-up of the cell's shapes."""


def read(run):
    return run["setup_s"]
