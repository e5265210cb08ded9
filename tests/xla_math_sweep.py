"""Every float32 value of the terrain's ranges through the port's XLA-rounded
``cos``, ``arctan`` and ``exp`` and through JAX's, on the CPU.

    JAX_PLATFORMS=cpu python tests/xla_math_sweep.py

Not a test (about 15 minutes on a few cores): the test suite checks a dense
sample of the same ranges (``test_torch_advanced.py::
test_xla_transcendentals_equal_jax_on_the_terrain_range``).  Prints, for
each function, the values checked and how many differ.
"""

import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from gymca_torch.envs import terrain  # noqa: E402

RANGES = (("cos", jnp.cos, 0.0, float(np.float32(np.pi / 2))),
          ("atan", jnp.arctan, -10.0, 10.0),
          ("exp", jnp.exp, -7.1, 7.1))
CHUNK = 1 << 24


def sweep(name, jax_fn, lo, hi):
    port_fn, want_fn = getattr(terrain, f"xla_{name}"), jax.jit(jax_fn)
    checked = differ = 0
    for sign, a, b in ((1.0, max(lo, 0.0), hi), (-1.0, max(-hi, 0.0), -lo)):
        if b <= a:
            continue
        first, last = (int(v) for v in np.float32([a, b]).view(np.int32))
        for start in range(first, last + 1, CHUNK):
            bits = np.arange(start, min(start + CHUNK, last + 1), dtype=np.int64)
            x = bits.astype(np.int32).view(np.float32) * np.float32(sign)
            got = port_fn(torch.from_numpy(x)).numpy()
            differ += int((got != np.asarray(want_fn(x))).sum())
            checked += x.size
    return checked, differ


if __name__ == "__main__":
    for name, fn, lo, hi in RANGES:
        t0 = time.time()
        checked, differ = sweep(name, fn, lo, hi)
        print(f"{name}: every float32 in [{lo}, {hi}]: {checked} values, {differ} differ "
              f"({time.time() - t0:.0f} s)", flush=True)
