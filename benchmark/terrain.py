"""The Advanced env's hidden terrain, drawn by the benchmark from the seed.

The terrain is an input of the env (its constructor takes it) that the
benchmark hands to the program and to the reference alike.  It is drawn here
in the distributions of gym-cellular-automata's Advanced env, with a
``torch.Generator`` on the device in a few batched calls:

* vegetation and density: 4-7 random rectangles of type 1..5 (each side
  3 to half the grid), the rest of the cells of type 1..3;
* altitude: uniform noise in [0, 5), 6-9 cosine hills (radius 2 to a
  quarter of the grid, height 2-6) and 4-7 linear ramps (height 1-4), / 10;
* slope: ``degrees(atan(alt - alt_neighbour))``, diagonals / 1.414, flat
  border, zero centre; ``exp_slope = exp(0.078 slope)`` direction-major and
  ``veg_den_factor = (1 + p_veg)(1 + p_den)``, both bfloat16 as the CA
  streams them.
"""

from __future__ import annotations

import math

import torch

VEG_PROBS = (-999.0, -0.1, 0.2, 0.5, 0.8, 1.2)
DEN_PROBS = (-999.0, -0.2, 0.2, 0.5, 0.8, 1.2)
SLOPE_COEFF = 0.078


def _ints(gen, lo, hi, n, dev, count=None):
    shape = (n,) if count is None else (count, n)
    return torch.randint(lo, hi, shape, generator=gen, device=dev)


def _patches(gen, n, h, w, dev, max_patches=7):
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    count = _ints(gen, 4, 8, n, dev)
    cr, cc = _ints(gen, 0, h, n, dev, max_patches), _ints(gen, 0, w, n, dev, max_patches)
    ph = _ints(gen, 3, max(h // 2, 4), n, dev, max_patches) // 2
    pw = _ints(gen, 3, max(w // 2, 4), n, dev, max_patches) // 2
    kind = _ints(gen, 1, 6, n, dev, max_patches)
    field = torch.zeros((n, h, w), dtype=torch.int32, device=dev)
    for i in range(max_patches):
        inside = ((rows >= (cr[i] - ph[i])[:, None, None]) & (rows < (cr[i] + ph[i])[:, None, None])
                  & (cols >= (cc[i] - pw[i])[:, None, None])
                  & (cols < (cc[i] + pw[i])[:, None, None]))
        field = torch.where(inside & (i < count)[:, None, None], kind[i, :, None, None].int(),
                            field)
    filler = torch.randint(1, 4, (n, h, w), generator=gen, device=dev, dtype=torch.int32)
    return torch.where(field == 0, filler, field)


def _altitude(gen, n, h, w, dev):
    rows = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    cols = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    alt = torch.rand((n, h, w), generator=gen, device=dev) * 5.0
    hills = 9
    count = _ints(gen, 6, 10, n, dev)
    cr = _ints(gen, 0, h, n, dev, hills).float()
    cc = _ints(gen, 0, w, n, dev, hills).float()
    radius = _ints(gen, 2, max(min(h, w) // 4, 3), n, dev, hills).float()
    height = 2.0 + 4.0 * torch.rand((hills, n), generator=gen, device=dev)
    for i in range(hills):
        dist = torch.sqrt((rows - cr[i, :, None, None]) ** 2 + (cols - cc[i, :, None, None]) ** 2)
        r = radius[i, :, None, None]
        bump = torch.where(dist < r, height[i, :, None, None] * torch.cos(dist / r * math.pi / 2),
                           0.0)
        alt = alt + torch.where((i < count)[:, None, None], bump, 0.0)
    ramps = 7
    count = _ints(gen, 4, 8, n, dev)
    sr = _ints(gen, 0, max(h - 4, 1), n, dev, ramps)
    sc = _ints(gen, 0, max(w - 4, 1), n, dev, ramps)
    rw = _ints(gen, 3, max(w // 4, 4), n, dev, ramps)
    rh = _ints(gen, 3, max(h // 4, 4), n, dev, ramps)
    diff = 1.0 + 3.0 * torch.rand((ramps, n), generator=gen, device=dev)
    for i in range(ramps):
        r0, c0 = sr[i, :, None, None], sc[i, :, None, None]
        hh = rh[i, :, None, None]
        inside = (rows >= r0) & (rows < r0 + hh) & (cols >= c0) & (cols < c0 + rw[i, :, None, None])
        ramp = torch.where(inside, diff[i, :, None, None] * (rows - r0) / hh.clamp(min=1), 0.0)
        alt = alt + torch.where((i < count)[:, None, None], ramp, 0.0)
    return alt / 10.0


def _slope(alt):
    n, h, w = alt.shape
    padded = torch.nn.functional.pad(alt[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    slope = torch.zeros((n, h, w, 3, 3), dtype=torch.float32, device=alt.device)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di or dj:
                d = alt - padded[:, 1 + di:1 + di + h, 1 + dj:1 + dj + w]
                if di and dj:
                    d = d / 1.414
                slope[..., 1 + di, 1 + dj] = torch.rad2deg(torch.atan(d))
    interior = torch.zeros((h, w), dtype=torch.bool, device=alt.device)
    interior[1:-1, 1:-1] = True
    return torch.where(interior[:, :, None, None], slope, 0.0)


def make_terrain(n: int, h: int, w: int, seed: int, device) -> dict:
    """The six terrain tensors of ``n`` envs, the same for the same seed."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) ^ 0x7E44A1)
    vegetation = _patches(gen, n, h, w, dev)
    density = _patches(gen, n, h, w, dev)
    altitude = _altitude(gen, n, h, w, dev)
    slope = _slope(altitude)
    veg = torch.tensor(VEG_PROBS, device=dev)
    den = torch.tensor(DEN_PROBS, device=dev)
    vdf = ((1.0 + veg[vegetation.long()]) * (1.0 + den[density.long()])).to(torch.bfloat16)
    exp_slope = torch.exp(SLOPE_COEFF * slope.permute(0, 3, 4, 1, 2)).contiguous()
    return {"density": density, "vegetation": vegetation, "altitude": altitude, "slope": slope,
            "exp_slope": exp_slope.to(torch.bfloat16), "veg_den_factor": vdf}
