"""int16 phantoms, made on the device from the seed: torso CT volumes
for a mix of [z, y, x] entries, chest radiographs for [rows, cols].

The shapes are the traffic's; the content (noise, and the anatomy of each
image jittered by a few per cent) comes from one device generator seeded
with the run's seed, so a seed gives the same images on every run and every
seed the same work.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

CHUNK = 64   # slices made at a time: bounds the device memory of a volume
ROWS = 512   # radiograph rows made at a time


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


def chest_xr(shape_hw: Sequence[int], generator: torch.Generator,
             device) -> np.ndarray:
    """One (rows, cols) int16 chest radiograph on the host, 12-bit DX
    storage in 0..4095, MONOCHROME2 (bone bright): a collimation border of
    zeros on each side, dark direct exposure, the body, two darker lungs,
    the heart's shadow, the spine, rib arcs over the lungs, Gaussian noise;
    the border widths and the geometry drawn from ``generator``."""
    h, w = (int(n) for n in shape_hw)
    j = (1.0 + 0.06 * (torch.rand(6, generator=generator, device=device)
                       - 0.5)).tolist()
    b = (0.02 + 0.05 * torch.rand(4, generator=generator,
                                  device=device)).tolist()
    top, bottom = int(b[0] * h), h - int(b[1] * h)
    left, right = int(b[2] * w), w - int(b[3] * w)
    out = np.empty((h, w), np.int16)
    u = torch.arange(w, dtype=torch.float32, device=device)[None, :] / w
    inside_x = ((u * w >= left) & (u * w < right))
    for r0 in range(0, h, ROWS):
        n = min(ROWS, h - r0)
        v = torch.arange(r0, r0 + n, dtype=torch.float32,
                         device=device)[:, None] / h
        noise = torch.randn((n, w), generator=generator, device=device)
        body = (((u - 0.5) / (0.40 * j[0])) ** 2
                + ((v - 0.58) / (0.52 * j[1])) ** 2) <= 1.0
        img = torch.where(body, 1500 + 300 * (v - 0.5), torch.tensor(
            60.0, device=device)) + 25 * noise
        for side in (-1, 1):
            lung = (((u - 0.5 - side * 0.17 * j[2]) / (0.12 * j[3])) ** 2
                    + ((v - 0.44) / (0.25 * j[3])) ** 2) <= 1.0
            img = torch.where(lung & body, 650 + 40 * noise, img)
            for k in range(8):
                y0 = 0.26 * j[4] + 0.055 * k
                arc = (v - y0 - 0.9 * (u - 0.5 - side * 0.10) ** 2).abs()
                rib = (arc <= 0.008) & body & ((u - 0.5) * side > 0.04)
                img = torch.where(rib, img + 600, img)
        heart = (((u - 0.54) / (0.12 * j[5])) ** 2
                 + ((v - 0.62) / (0.11 * j[5])) ** 2) <= 1.0
        img = torch.where(heart & body, 1750 + 30 * noise, img)
        spine = ((u - 0.5).abs() <= 0.035 * j[4]) & body
        vert = 2500 + 250 * (torch.sin(v * h / (11.0 * j[5])) > 0).float()
        img = torch.where(spine, vert + 40 * noise, img)
        rows = (v * h >= top) & (v * h < bottom)
        img = torch.where(rows & inside_x, img.round().clamp(1, 4095), 0.0)
        out[r0:r0 + n] = img.to(torch.int16).cpu().numpy()
    return out


def volumes(shapes: Sequence[Sequence[int]], seed: int, device) -> list:
    """The traffic's images, in order, from one generator seeded ``seed``:
    a torso CT for each [z, y, x] entry, a chest radiograph for each
    [rows, cols] one."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return [chest_xr(s, gen, device) if len(s) == 2 else
            torso_ct(s, gen, device) for s in shapes]
