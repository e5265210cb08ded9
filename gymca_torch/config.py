"""Canonical dtypes and the default device of gymca_torch.

Counterpart of ``gymca_tpu/config.py``: float32 for continuous values, int32
for cell states, positions and counters.  Entry points run on the card
(``DEFAULT_DEVICE``) unless the caller names another device; without a CUDA
device they raise instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch

TYPE_BOX = torch.float32  # continuous context values
TYPE_INT = torch.int32  # cell states, positions, counters

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device``, else the card.

    Raises when the card is asked for (explicitly or by default) and no CUDA
    device exists; pass ``device="cpu"`` to run on the CPU.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gymca_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
