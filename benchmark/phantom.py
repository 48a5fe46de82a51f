"""int16 torso CT phantoms, made on the device from the seed.

The shapes are the traffic's; the content (noise, and the body, lungs,
spine and rib shell of each volume jittered by a few per cent) comes from
one device generator seeded with the run's seed, so a seed gives the same
volumes on every run and every seed the same work.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

CHUNK = 64   # slices made at a time: bounds the device memory of a volume


def torso_ct(shape_zyx: Sequence[int], generator: torch.Generator,
             device) -> np.ndarray:
    """One (z, y, x) int16 volume on the host: air, an elliptic body
    tapering along z, two lungs, a spine with vertebral banding, rib shell
    bands, Gaussian noise; the geometry jittered from ``generator``."""
    z, y, x = (int(n) for n in shape_zyx)
    j = 1.0 + 0.06 * (torch.rand(6, generator=generator, device=device) - 0.5)
    j = j.tolist()
    out = np.empty((z, y, x), np.int16)
    yy = torch.arange(y, dtype=torch.float32, device=device)[None, :, None]
    xx = torch.arange(x, dtype=torch.float32, device=device)[None, None, :]
    for z0 in range(0, z, CHUNK):
        n = min(CHUNK, z - z0)
        zi = torch.arange(z0, z0 + n, dtype=torch.float32,
                          device=device)[:, None, None]
        zc = zi / max(z - 1, 1)
        noise = torch.randn((n, y, x), generator=generator, device=device)
        taper = 0.85 + 0.3 * torch.sin(zc * math.pi)
        r2 = (((yy - y * 0.52 * j[0]) / (y * 0.38 * j[1] * taper)) ** 2
              + ((xx - x * 0.50) / (x * 0.42 * j[1] * taper)) ** 2)
        body = r2 <= 1.0
        vol = torch.where(body, 35 + 25 * torch.sin(zc * 7.0) + 12 * noise,
                          torch.tensor(-1024.0, device=device))
        for side in (-1, 1):
            lung = ((((zi - z * 0.30 * j[2]) / (z * 0.22 * j[3])) ** 2
                     + ((yy - y * 0.42) / (y * 0.20 * j[3])) ** 2
                     + ((xx - x * (0.5 + side * 0.18)) / (x * 0.16 * j[3]))
                     ** 2) <= 1.0) & body
            vol = torch.where(lung, -820 + 25 * noise, vol)
        spine = ((((yy - y * 0.78) / (y * 0.07 * j[4])) ** 2
                  + ((xx - x * 0.5) / (x * 0.10 * j[4])) ** 2) <= 1.0) & body
        vert = 650 + 350 * (torch.sin(zi / (3.4 * j[5])) > 0).float()
        vol = torch.where(spine, vert + 40 * noise, vol)
        shell = (r2 >= 0.82) & body & (torch.sin(zi / (2.1 * j[5])) > 0.3)
        vol = torch.where(shell, 420 + 60 * noise, vol)
        out[z0:z0 + n] = (vol.round().clamp(-1024, 3071).to(torch.int16)
                          .cpu().numpy())
    return out


def volumes(shapes: Sequence[Sequence[int]], seed: int, device) -> list:
    """The traffic's volumes, in order, from one generator seeded ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return [torso_ct(s, gen, device) for s in shapes]
