"""The numbers that decide ``correct``: mismatches between the program's
answers and the reference's, leaf by leaf."""

from __future__ import annotations

import torch


def values_wrong(program: dict, reference: dict, leaves) -> int:
    """How many values of ``leaves`` differ; a leaf of another shape counts
    every value of the reference's as wrong."""
    wrong = 0
    for k in leaves:
        a, b = program[k], reference[k].to(program[k].device)
        if a.shape != b.shape:
            wrong += b.numel()
        else:
            wrong += int((a.to(b.dtype) != b).sum())
    return wrong


def largest_gap(program: dict, reference: dict, leaves) -> float:
    """The largest absolute difference over ``leaves``: inf for a shape that
    differs, NaN where either side is NaN."""
    gap = 0.0
    for k in leaves:
        a, b = program[k].double(), reference[k].to(program[k].device).double()
        if a.shape != b.shape:
            return float("inf")
        if a.numel():
            d = float((a - b).abs().max())  # NaN if any difference is NaN
            if d != d:
                return d
            gap = max(gap, d)
    return gap
