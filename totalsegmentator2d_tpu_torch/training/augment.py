"""Data augmentation on the device: the nnU-Net default 2D recipe (the
reference package's training/augment.py) on tensors.

Transforms, with the nnUNetTrainer default probabilities (nnunetv2
get_training_transforms):

 1. spatial: rotation U(-180°, 180°) p=0.2, zoom U(0.7, 1.4) p=0.2,
    optional elastic deformation (off by default, as in nnU-Net v2),
    composed into one order-3 B-spline resample of the image (constant 0
    outside) and an order-1 + 0.5-threshold resample of the one-hot
    target. ``TS2D_WARP`` picks the sampler: ``matmul`` (default) builds
    one-hot row/column weight matrices and multiplies (``warp_image``;
    ``warp_image_affine`` at tile-local window size for affine grids) and
    takes the target's four taps in one gather each (``warp_onehot``);
    ``gather`` samples tap by tap (``map_coordinates``). ``TS2D_SPATIAL``
    picks the batch form: ``partition`` (default, batches of 8 or more
    without elastic) warps a random subset of exactly round(B * p_any)
    samples; ``persample`` draws each sample's Bernoulli on its own. Either
    way the samples that warp are warped as ONE (K, H, W, C) stack, so the
    B-spline prefilter (the CUDA kernel on the card) runs once per axis per
    step, not once per sample.
 2. gaussian noise p=0.1, variance U(0, 0.1)
 3. gaussian blur p=0.2, sigma U(0.5, 1.0), per-channel p=0.5
 4. multiplicative brightness U(0.75, 1.25) p=0.15
 5. contrast U(0.75, 1.25) p=0.15, range-preserving
 6. simulated low resolution p=0.25, per-channel p=0.5, zoom drawn from
    ``LOWRES_ZOOMS`` (the reference's discrete levels), nearest down and
    cubic up (skimage edge mode): the channels that draw one level are
    resized as one stack
 7. inverted gamma U(0.7, 1.5) p=0.1, stats-retaining
 8. gamma U(0.7, 1.5) p=0.3, stats-retaining
 9. mirror flips p=0.5 per axis

Layouts are the reference's: an image (H, W, C) float, a target (H, W, L)
uint8 one-hot, sampling coordinates (2, H', W'); batched forms carry a
leading sample axis. Random draws come from an explicit ``torch.Generator``
(on the CPU, so a seed gives the same draws on any device; the noise field
itself comes from a device generator seeded from it). They cannot equal
``jax.random``'s streams: the tests hold each transform against the
reference at fixed parameters.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resample import _resize, bspline_prefilter
from ..utils.device import exact_numerics

#: discrete zoom levels of the low-resolution simulation
LOWRES_ZOOMS = (0.5, 0.6, 0.7, 0.8, 0.9)

#: output pixels per matmul step of warp_image
_WARP_CHUNK = 2048

#: tiles per step of warp_image_affine: bounds its one-hot temporaries
_WARP_TILE_CHUNK = 64

#: spatial_transform's default draw ranges (nnU-Net 2D defaults), shared
#: with the batch-partitioned form
ROTATION_RANGE = (-math.pi, math.pi)
SCALE_RANGE = (0.7, 1.4)


def _spatial_mode() -> str:
    """The batch spatial-augmentation form (``TS2D_SPATIAL``): 'partition'
    (default) warps a random subset of exactly round(B * p_any) samples;
    'persample' draws each sample on its own (also taken for elastic
    deformation and batches under 8)."""
    value = os.environ.get('TS2D_SPATIAL', 'partition')
    if value not in ('partition', 'persample'):
        raise ValueError(
            f"TS2D_SPATIAL must be 'partition' or 'persample', got {value!r}")
    return value


def _use_fast_warp() -> bool:
    """The spatial sampler (``TS2D_WARP``): 'matmul' (default, one-hot
    matmuls and a 4-tap gather for the target) or 'gather' (the per-tap
    ``map_coordinates``); the two agree (tests/test_torch_augment.py)."""
    value = os.environ.get('TS2D_WARP', 'matmul')
    if value not in ('matmul', 'gather'):
        raise ValueError(
            f"TS2D_WARP must be 'matmul' or 'gather', got {value!r}")
    return value == 'matmul'


def _uniform(u: torch.Tensor, rng: Tuple[float, float]) -> torch.Tensor:
    """U(0, 1) draws -> U(rng); a degenerate range gives its value exactly."""
    return rng[0] + u * (rng[1] - rng[0])


# ---------------------------------------------------------------------------
# interpolation core (batched: (K, H, W, C) images, (K, 2, ...) coordinates)
# ---------------------------------------------------------------------------

def _mirror_idx(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect integer indices into [0, n): scipy mode='mirror', period
    2n-2."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * n - 2
    m = torch.remainder(idx, period)
    return torch.where(m >= n, period - m, m)


def _bspline3(t: torch.Tensor) -> torch.Tensor:
    at = torch.abs(t)
    return torch.where(
        at < 1.0, 2.0 / 3.0 - at * at + 0.5 * at ** 3,
        torch.where(at < 2.0, ((2.0 - at) ** 3) / 6.0, torch.zeros_like(at)))


def _valid(coords: torch.Tensor, H: int, W: int) -> torch.Tensor:
    y, x = coords[:, 0], coords[:, 1]
    return (y >= 0) & (y <= H - 1) & (x >= 0) & (x <= W - 1)


def _map_batch(img: torch.Tensor, coords: torch.Tensor, order: int,
               mode: str, cval: float, prefiltered: bool) -> torch.Tensor:
    K, H, W, _ = img.shape
    y, x = coords[:, 0], coords[:, 1]
    kk = torch.arange(K, device=img.device).view((K,) + (1,) * (y.ndim - 1))
    if order == 0:
        iy = _mirror_idx(torch.floor(y + 0.5).long(), H)
        ix = _mirror_idx(torch.floor(x + 0.5).long(), W)
        out = img[kk, iy, ix]
    elif order in (1, 3):
        c = img
        if order == 3 and not prefiltered:
            c = bspline_prefilter(img.float(), (1, 2))
        y0f, x0f = torch.floor(y), torch.floor(x)
        y0, x0 = y0f.long(), x0f.long()
        if order == 1:
            ty, tx = y - y0f, x - x0f
            wys = ((0, 1.0 - ty), (1, ty))
            wxs = ((0, 1.0 - tx), (1, tx))
        else:
            wys = [(d, _bspline3(y - (y0f + d))) for d in range(-1, 3)]
            wxs = [(d, _bspline3(x - (x0f + d))) for d in range(-1, 3)]
        out = 0.0
        for dy, wy in wys:
            iy = _mirror_idx(y0 + dy, H)
            for dx, wx in wxs:
                v = c[kk, iy, _mirror_idx(x0 + dx, W)]
                out = out + v * (wy * wx)[..., None]
    else:
        raise ValueError(f'Unsupported interpolation order: {order}')
    if mode == 'constant':
        out = torch.where(_valid(coords, H, W)[..., None], out,
                          torch.as_tensor(cval, dtype=out.dtype,
                                          device=out.device))
    elif mode != 'mirror':
        raise ValueError(f'Unsupported mode: {mode}')
    return out


def _per_sample(fn, img: torch.Tensor, coords: torch.Tensor, *args,
                channel_axis: bool = True):
    """Run a batched sampler on one (H, W[, C]) image and (2, ...) coords."""
    chan = img.ndim == 3 or not channel_axis
    x = img if chan else img[..., None]
    out = fn(x[None], coords[None], *args)[0]
    return out if chan else out[..., 0]


def map_coordinates(img: torch.Tensor, coords: torch.Tensor, order: int,
                    mode: str = 'mirror', cval: float = 0.0,
                    prefiltered: bool = False) -> torch.Tensor:
    """Sample ``img`` (H, W) or (H, W, C) (or a (K, H, W, C) stack with
    (K, 2, ...) coordinates) at continuous index positions ``coords``
    (2, ...): scipy.ndimage.map_coordinates semantics. order 0 nearest, 1
    linear, 3 cubic B-spline (prefiltered here unless ``prefiltered``).
    mode 'mirror' reflects; 'constant' fills positions whose coordinate
    leaves [0, n-1] with ``cval`` (interior values still interpolate over
    the mirrored neighbourhood)."""
    if img.ndim == 4:
        return _map_batch(img, coords, order, mode, cval, prefiltered)
    return _per_sample(_map_batch, img, coords, order, mode, cval,
                       prefiltered)


def _tap_data(coords: torch.Tensor, order: int, shape: Tuple[int, int]):
    """Mirror-folded tap indices and weights of a flattened output grid:
    coords (K, 2, H', W') -> iy / ix (K, P, S) int64, wy / wx (K, P, S)
    float32, S = 4 (order 3) or 2 (order 1): ``map_coordinates``'s taps,
    laid out tap-minor."""
    H, W = shape
    K = coords.shape[0]
    y = coords[:, 0].reshape(K, -1)
    x = coords[:, 1].reshape(K, -1)
    y0f, x0f = torch.floor(y), torch.floor(x)
    if order == 3:
        offs = range(-1, 3)
        wy = torch.stack([_bspline3(y - (y0f + d)) for d in offs], -1)
        wx = torch.stack([_bspline3(x - (x0f + d)) for d in offs], -1)
    elif order == 1:
        offs = range(0, 2)
        ty, tx = y - y0f, x - x0f
        wy = torch.stack([1.0 - ty, ty], -1)
        wx = torch.stack([1.0 - tx, tx], -1)
    else:
        raise ValueError(f'Unsupported fast-warp order: {order}')
    iy = torch.stack([_mirror_idx(y0f.long() + d, H) for d in offs], -1)
    ix = torch.stack([_mirror_idx(x0f.long() + d, W) for d in offs], -1)
    return iy, ix, wy, wx


def _one_hot_weights(idx: torch.Tensor, w: torch.Tensor,
                     n: int) -> torch.Tensor:
    """(..., S) tap indices and weights -> the (..., n) weighted one-hot
    rows, summed tap by tap."""
    lanes = torch.arange(n, device=idx.device)
    out = torch.zeros(idx.shape[:-1] + (n,), dtype=torch.float32,
                      device=idx.device)
    for d in range(idx.shape[-1]):
        out = out + w[..., d, None] * (idx[..., d, None] == lanes).float()
    return out


def _warp_image_batch(img: torch.Tensor, coords: torch.Tensor, order: int,
                      cval: float, prefiltered: bool) -> torch.Tensor:
    K, H, W, C = img.shape
    src = img.float()
    if order == 3 and not prefiltered:
        src = bspline_prefilter(src, (1, 2))
    Ho, Wo = coords.shape[2], coords.shape[3]
    iy, ix, wy, wx = _tap_data(coords, order, (H, W))
    imgf = src.reshape(K, H, W * C)
    outs = []
    with exact_numerics():
        for c0 in range(0, Ho * Wo, _WARP_CHUNK):
            sl = slice(c0, c0 + _WARP_CHUNK)
            Ry = _one_hot_weights(iy[:, sl], wy[:, sl], H)
            Rx = _one_hot_weights(ix[:, sl], wx[:, sl], W)
            tmp = torch.bmm(Ry, imgf).reshape(K, -1, W, C)
            outs.append(torch.einsum('kpw,kpwc->kpc', Rx, tmp))
    out = torch.cat(outs, 1).reshape(K, Ho, Wo, C)
    return torch.where(_valid(coords, H, W)[..., None], out,
                       torch.tensor(cval, device=out.device))


def warp_image(img: torch.Tensor, coords: torch.Tensor, order: int = 3,
               cval: float = 0.0, prefiltered: bool = False) -> torch.Tensor:
    """mode='constant' resample of a channelled image (H, W, C) (or a
    (K, H, W, C) stack) at ``coords`` (2, H', W') by one-hot matmuls: per
    chunk of output pixels, row / column weight matrices Ry (P, H) and
    Rx (P, W) from the mirrored taps, and (Ry @ img) @ Rx in full fp32.
    Equals ``map_coordinates(img, coords, order, 'constant')`` to fp32
    rounding."""
    if img.ndim == 4:
        return _warp_image_batch(img, coords, order, cval, prefiltered)
    return _per_sample(_warp_image_batch, img, coords, order, cval,
                       prefiltered)


def _win_size(tile: int, order: int, smax: float) -> int:
    """Source-window size holding every tap of one tile x tile output
    block under a map whose per-axis Lipschitz constant is at most
    ``smax * sqrt(2)`` (a rotation with zoom <= smax), a multiple of 8."""
    span = (tile - 1) * smax * math.sqrt(2.0)
    taps = 4 if order == 3 else 2
    w = int(math.ceil(span)) + taps + 1
    return -(-w // 8) * 8


def _warp_affine_batch(img: torch.Tensor, coords: torch.Tensor, order: int,
                       cval: float, smax: float, tile: int,
                       prefiltered: bool) -> torch.Tensor:
    K, H, W, C = img.shape
    WIN = _win_size(tile, order, smax)
    Hp, Wp = H + 4, W + 4
    if WIN > Hp or WIN > Wp:
        return _warp_image_batch(img, coords, order, cval, prefiltered)
    dev = img.device
    src = img.float()
    if order == 3 and not prefiltered:
        src = bspline_prefilter(src, (1, 2))
    # a 2-pixel reflect border: order-3 taps of in-range coordinates reach
    # at most 2 outside
    pad = F.pad(src.permute(0, 3, 1, 2), (2, 2, 2, 2),
                mode='reflect').permute(0, 2, 3, 1)

    Ho, Wo = coords.shape[2], coords.shape[3]
    Ht, Wt = -(-Ho // tile), -(-Wo // tile)
    grow = (0, Wt * tile - Wo, 0, Ht * tile - Ho)
    y = F.pad(torch.clamp(coords[:, 0:1], 0.0, H - 1.0), grow, mode='replicate')
    x = F.pad(torch.clamp(coords[:, 1:2], 0.0, W - 1.0), grow, mode='replicate')

    def tiled(a):
        return a.reshape(K, Ht, tile, Wt, tile).permute(0, 1, 3, 2, 4).reshape(
            K, Ht * Wt, tile * tile)

    y, x = tiled(y), tiled(x)
    T = y.shape[1]
    y0f, x0f = torch.floor(y), torch.floor(x)
    y0, x0 = y0f.long(), x0f.long()
    ys = torch.clamp(torch.amin(y0, dim=2) + 1, 0, Hp - WIN)   # (K, T)
    xs = torch.clamp(torch.amin(x0, dim=2) + 1, 0, Wp - WIN)
    if order == 3:
        offs = range(-1, 3)
        wy = torch.stack([_bspline3(y - (y0f + d)) for d in offs], -1)
        wx = torch.stack([_bspline3(x - (x0f + d)) for d in offs], -1)
    elif order == 1:
        offs = range(0, 2)
        ty, tx = y - y0f, x - x0f
        wy = torch.stack([1.0 - ty, ty], -1)
        wx = torch.stack([1.0 - tx, tx], -1)
    else:
        raise ValueError(f'Unsupported fast-warp order: {order}')
    doffs = torch.tensor(list(offs), device=dev)
    iy = y0[..., None] + doffs + 2 - ys[:, :, None, None]     # (K, T, P, S)
    ix = x0[..., None] + doffs + 2 - xs[:, :, None, None]
    lanes = torch.arange(WIN, device=dev)
    kk = torch.arange(K, device=dev)[:, None, None, None]
    outs = []
    with exact_numerics():
        for t0 in range(0, T, _WARP_TILE_CHUNK):
            ts = slice(t0, t0 + _WARP_TILE_CHUNK)
            rows = (ys[:, ts, None] + lanes)[:, :, :, None]
            cols = (xs[:, ts, None] + lanes)[:, :, None, :]
            win = pad[kk, rows, cols]                    # (K, g, WIN, WIN, C)
            g = win.shape[1]
            Ry = _one_hot_weights(iy[:, ts], wy[:, ts], WIN)  # (K, g, P, WIN)
            Rx = _one_hot_weights(ix[:, ts], wx[:, ts], WIN)
            tmp = torch.matmul(Ry, win.reshape(K, g, WIN, WIN * C))
            outs.append(torch.einsum('ktpw,ktpwc->ktpc', Rx,
                                     tmp.reshape(K, g, -1, WIN, C)))
    out = torch.cat(outs, 1).reshape(K, Ht, Wt, tile, tile, C)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(K, Ht * tile, Wt * tile, C)
    out = out[:, :Ho, :Wo]
    return torch.where(_valid(coords, H, W)[..., None], out,
                       torch.tensor(cval, device=dev))


def warp_image_affine(img: torch.Tensor, coords: torch.Tensor,
                      order: int = 3, cval: float = 0.0, smax: float = 1.4,
                      tile: int = 32, prefiltered: bool = False
                      ) -> torch.Tensor:
    """``warp_image`` for AFFINE sampling grids (rotation + zoom <=
    ``smax``, every ``affine_grid``): a tile x tile output block reads a
    bounded source window (``_win_size``), so each tile's one-hot matmuls
    run at the window size instead of the full image (about 13x fewer
    operations at tile 32 on 256^2 patches); tiles go in chunks of
    ``_WARP_TILE_CHUNK``. Falls back to ``warp_image`` when the image is
    smaller than the window. Needs the Lipschitz bound: free-form
    coordinates (elastic offsets) use ``warp_image``."""
    if img.ndim == 4:
        return _warp_affine_batch(img, coords, order, cval, smax, tile,
                                  prefiltered)
    return _per_sample(_warp_affine_batch, img, coords, order, cval, smax,
                       tile, prefiltered)


def _warp_onehot_batch(target: torch.Tensor,
                       coords: torch.Tensor) -> torch.Tensor:
    K, H, W, L = target.shape
    Ho, Wo = coords.shape[2], coords.shape[3]
    iy, ix, wy, wx = _tap_data(coords, 1, (H, W))          # (K, P, 2)
    src = (target > 0).float().reshape(K, H * W, L)
    acc = 0.0
    for a in (0, 1):          # map_coordinates' term order
        for b in (0, 1):
            idx = (iy[:, :, a] * W + ix[:, :, b])[..., None].expand(-1, -1, L)
            acc = acc + torch.gather(src, 1, idx) * (wy[:, :, a]
                                                     * wx[:, :, b])[..., None]
    out = (acc > 0.5).reshape(K, Ho, Wo, L)
    return out & _valid(coords, H, W)[..., None]


def warp_onehot(target: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Order-1 + 0.5-threshold mode='constant' warp of a binary one-hot
    target (H, W, L) (or a (K, H, W, L) stack) -> bool (H', W', L): each
    output pixel gathers its four taps of all L labels at once and sums
    them in ``map_coordinates``' term order, so it equals
    ``map_coordinates(target.float(), coords, 1, 'constant') > 0.5`` bit for
    bit."""
    if target.ndim == 4:
        return _warp_onehot_batch(target, coords)
    return _per_sample(_warp_onehot_batch, target, coords)


def gaussian_blur(img: torch.Tensor, sigma, radius: int = 5,
                  axes: Sequence[int] = (0, 1)) -> torch.Tensor:
    """Separable gaussian blur truncated at ``radius`` (scipy's ``radius=``),
    symmetric (edge-repeating, scipy 'reflect') boundary. ``sigma`` is a
    number or a tensor that broadcasts against ``img`` (one sigma per
    sample and channel)."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=img.device)
    t = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=img.device)
    w = torch.exp(-0.5 * (t / sigma[..., None]) ** 2)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    out = img
    for ax in axes:
        ax = ax % out.ndim
        n = out.shape[ax]
        idx = torch.from_numpy(np.pad(np.arange(n), radius, mode='symmetric'))
        padded = torch.index_select(out, ax, idx.to(img.device))
        acc = 0.0
        for k in range(2 * radius + 1):
            acc = acc + w[..., k] * torch.narrow(padded, ax, k, n)
        out = acc
    return out


# ---------------------------------------------------------------------------
# individual transforms (batched: image (N, H, W, C) float, target
# (N, H, W, L) uint8)
# ---------------------------------------------------------------------------

def affine_grid(shape: Tuple[int, int], angle, scale) -> torch.Tensor:
    """Output -> input sampling grid (2, H, W) for a rotation by ``angle``
    (radians) and a zoom by ``scale`` about the patch centre; 1-D tensors
    of K angles and scales give (K, 2, H, W). scale > 1 spreads the
    sampling positions: the content shrinks (batchgenerators' convention)."""
    H, W = shape
    angle = torch.as_tensor(angle, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=angle.device)
    dev = angle.device
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev) - cy,
        torch.arange(W, dtype=torch.float32, device=dev) - cx, indexing='ij')
    batched = angle.ndim == 1
    cos, sin = torch.cos(angle), torch.sin(angle)
    if batched:
        cos, sin = cos[:, None, None], sin[:, None, None]
        scale = scale[:, None, None]
    ys = (cos * yy - sin * xx) * scale + cy
    xs = (sin * yy + cos * xx) * scale + cx
    return torch.stack([ys, xs], dim=1 if batched else 0)


def elastic_offsets(gen: torch.Generator, shape: Tuple[int, int], alpha,
                    sigma, device=None) -> torch.Tensor:
    """Elastic displacement field (2, H, W): gaussian-smoothed U(-1, 1)
    noise scaled by ``alpha`` (batchgenerators elastic_deform_coordinates)."""
    noise = torch.rand((2,) + tuple(shape), generator=gen) * 2.0 - 1.0
    return gaussian_blur(noise.to(device), float(sigma)) * float(alpha)


def _warp_stack(images: torch.Tensor, targets: torch.Tensor,
                coords: torch.Tensor, affine: bool, smax: float):
    """Warp a (K, H, W, C) image stack and its (K, H, W, L) targets: image
    order 3 constant 0, target order 1 > 0.5."""
    if _use_fast_warp():
        if affine:
            w_img = warp_image_affine(images, coords, order=3, smax=smax)
        else:
            w_img = warp_image(images, coords, order=3)
        w_tgt = warp_onehot(targets, coords)
    else:
        w_img = map_coordinates(images, coords, order=3, mode='constant')
        w_tgt = map_coordinates(targets.float(), coords, order=1,
                                mode='constant') > 0.5
    return w_img, w_tgt.to(targets.dtype)


def _spatial_persample(gen: torch.Generator, images: torch.Tensor,
                       targets: torch.Tensor,
                       rotation: Tuple[float, float] = ROTATION_RANGE,
                       p_rot: float = 0.2,
                       scale: Tuple[float, float] = SCALE_RANGE,
                       p_scale: float = 0.2, p_elastic: float = 0.0,
                       elastic_alpha: Tuple[float, float] = (0.0, 200.0),
                       elastic_sigma: Tuple[float, float] = (9.0, 13.0)):
    """Independent per-sample draws; the samples that draw any component
    are warped as one stack, the rest pass through bit for bit."""
    N = images.shape[0]
    dev = images.device
    u = torch.rand((N, 7), generator=gen)
    do_rot = u[:, 0] < p_rot
    do_scale = u[:, 1] < p_scale
    do_el = (u[:, 2] < p_elastic) if p_elastic > 0 else torch.zeros(N, dtype=torch.bool)
    angle = torch.where(do_rot, _uniform(u[:, 3], rotation), 0.0)
    sc = torch.where(do_scale, _uniform(u[:, 4], scale), 1.0)
    sel = torch.nonzero(do_rot | do_scale | do_el).flatten()
    if sel.numel() == 0:
        return images.float(), targets
    coords = affine_grid(images.shape[1:3], angle[sel].to(dev),
                         sc[sel].to(dev))
    if p_elastic > 0:
        alpha = _uniform(u[:, 5], elastic_alpha)
        sig = _uniform(u[:, 6], elastic_sigma)
        for j, i in enumerate(sel.tolist()):
            if do_el[i]:
                coords[j] = coords[j] + elastic_offsets(
                    gen, images.shape[1:3], alpha[i], sig[i], dev)
    w_img, w_tgt = _warp_stack(images[sel.to(dev)].float(),
                               targets[sel.to(dev)], coords,
                               affine=not p_elastic,
                               smax=max(1.0, scale[1]))
    out_img, out_tgt = images.float().clone(), targets.clone()
    out_img[sel.to(dev)] = w_img
    out_tgt[sel.to(dev)] = w_tgt
    return out_img, out_tgt


def spatial_transform(gen: torch.Generator, image: torch.Tensor,
                      target: torch.Tensor,
                      rotation: Tuple[float, float] = ROTATION_RANGE,
                      p_rot: float = 0.2,
                      scale: Tuple[float, float] = SCALE_RANGE,
                      p_scale: float = 0.2, p_elastic: float = 0.0,
                      elastic_alpha: Tuple[float, float] = (0.0, 200.0),
                      elastic_sigma: Tuple[float, float] = (9.0, 13.0)):
    """Rotation + zoom (+ optional elastic deformation) of one (H, W, C)
    image and its (H, W, L) target, composed into ONE resample (image
    order 3 constant 0, target order 1 + 0.5 threshold); nothing is
    resampled when no component is drawn."""
    img, tgt = _spatial_persample(
        gen, image[None], target[None], rotation, p_rot, scale, p_scale,
        p_elastic, elastic_alpha, elastic_sigma)
    return img[0], tgt[0]


def spatial_transform_batch(gen: torch.Generator, images: torch.Tensor,
                            targets: torch.Tensor, p_rot: float = 0.2,
                            p_scale: float = 0.2,
                            rotation: Tuple[float, float] = ROTATION_RANGE,
                            scale: Tuple[float, float] = SCALE_RANGE):
    """Batch rotation + zoom warping a uniformly random subset of exactly
    K = round(B * p_any) samples, p_any = 1 - (1-p_rot)(1-p_scale); each
    warped sample draws its (rotation, zoom) pair from the distribution
    conditional on any, then its angle and zoom from the ranges (the
    reference's documented deviation: the per-batch count is the rounded
    mean, not Binomial(B, p_any)). The K samples warp as one stack."""
    B = images.shape[0]
    dev = images.device
    p_any = 1.0 - (1.0 - p_rot) * (1.0 - p_scale)
    K = int(round(B * p_any))
    if K == 0:
        return images, targets
    perm = torch.randperm(B, generator=gen)[:K]
    # P(rot only | any), P(scale only | any); the remainder draws both
    a = p_rot * (1.0 - p_scale) / p_any
    b = (1.0 - p_rot) * p_scale / p_any
    u = torch.rand((K, 3), generator=gen)
    do_rot = (u[:, 0] < a) | (u[:, 0] >= a + b)
    do_scale = u[:, 0] >= a
    angle = torch.where(do_rot, _uniform(u[:, 1], rotation), 0.0)
    sc = torch.where(do_scale, _uniform(u[:, 2], scale), 1.0)
    coords = affine_grid(images.shape[1:3], angle.to(dev), sc.to(dev))
    sel = perm.to(dev)
    w_img, w_tgt = _warp_stack(images[sel].float(), targets[sel], coords,
                               affine=True, smax=max(1.0, scale[1]))
    out_img, out_tgt = images.float().clone(), targets.clone()
    out_img[sel] = w_img
    out_tgt[sel] = w_tgt
    return out_img, out_tgt


def _per_sample_mask(do: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return do.to(x.device).view((-1,) + (1,) * (x.ndim - 1))


def add_gaussian_noise(gen: torch.Generator, image: torch.Tensor,
                       p: float = 0.1,
                       variance: Tuple[float, float] = (0.0, 0.1)
                       ) -> torch.Tensor:
    u = torch.rand((image.shape[0], 2), generator=gen)
    do = u[:, 0] < p
    sel = torch.nonzero(do).flatten()
    if sel.numel() == 0:
        return image
    std = torch.sqrt(_uniform(u[sel, 1], variance)).to(image.device)
    noise_gen = torch.Generator(image.device).manual_seed(
        int(torch.randint(0, 2 ** 62, (), generator=gen)))
    noise = torch.randn((sel.numel(),) + tuple(image.shape[1:]),
                        generator=noise_gen, device=image.device)
    out = image.clone()
    out[sel.to(image.device)] = image[sel.to(image.device)] \
        + noise * std.view(-1, 1, 1, 1)
    return out


def blur_transform(gen: torch.Generator, image: torch.Tensor, p: float = 0.2,
                   p_per_channel: float = 0.5,
                   sigma: Tuple[float, float] = (0.5, 1.0)) -> torch.Tensor:
    N, C = image.shape[0], image.shape[-1]
    u = torch.rand((N, 1 + 2 * C), generator=gen)
    do = (u[:, 0:1] < p) & (u[:, 1::2] < p_per_channel)       # (N, C)
    sel = torch.nonzero(do.any(dim=1)).flatten()
    if sel.numel() == 0:
        return image
    dev = image.device
    sig = _uniform(u[sel, 2::2], sigma).to(dev)[:, None, None, :]
    part = image[sel.to(dev)]
    blurred = gaussian_blur(part, sig, axes=(1, 2))
    out = image.clone()
    out[sel.to(dev)] = torch.where(do[sel].to(dev)[:, None, None, :],
                                   blurred, part)
    return out


def brightness_transform(gen: torch.Generator, image: torch.Tensor,
                         p: float = 0.15,
                         rng: Tuple[float, float] = (0.75, 1.25)
                         ) -> torch.Tensor:
    """Per-channel multiplicative brightness."""
    N, C = image.shape[0], image.shape[-1]
    u = torch.rand((N, 1 + C), generator=gen)
    mult = _uniform(u[:, 1:], rng).to(image.device)[:, None, None, :]
    return torch.where(_per_sample_mask(u[:, 0] < p, image), image * mult,
                       image)


def contrast_transform(gen: torch.Generator, image: torch.Tensor,
                       p: float = 0.15,
                       rng: Tuple[float, float] = (0.75, 1.25)
                       ) -> torch.Tensor:
    """Per-channel contrast about the channel mean, range-preserving
    (batchgenerators preserve_range=True)."""
    N, C = image.shape[0], image.shape[-1]
    u = torch.rand((N, 1 + C), generator=gen)
    factor = _uniform(u[:, 1:], rng).to(image.device)[:, None, None, :]
    mean = torch.mean(image, dim=(1, 2), keepdim=True)
    mn = torch.amin(image, dim=(1, 2), keepdim=True)
    mx = torch.amax(image, dim=(1, 2), keepdim=True)
    stretched = torch.minimum(torch.maximum((image - mean) * factor + mean,
                                            mn), mx)
    return torch.where(_per_sample_mask(u[:, 0] < p, image), stretched, image)


def lowres_level(x: torch.Tensor, z: float) -> torch.Tensor:
    """One low-resolution level on (..., H, W) planes: nearest-neighbour
    down to round(n * z) (at least 1), cubic back up, skimage edge mode
    (the reference's ``_resize_jit`` chain)."""
    H, W = x.shape[-2:]
    axes = (x.ndim - 2, x.ndim - 1)
    low = (max(1, int(round(H * z))), max(1, int(round(W * z))))
    small = _resize(x, low, 0, 'edge', axes)
    return _resize(small, (H, W), 3, 'edge', axes)


def lowres_transform(gen: torch.Generator, image: torch.Tensor,
                     p: float = 0.25,
                     p_per_channel: float = 0.5) -> torch.Tensor:
    """Simulated low resolution per channel at a drawn ``LOWRES_ZOOMS``
    level; all planes of one level resize as one stack."""
    N, C = image.shape[0], image.shape[-1]
    u = torch.rand((N, 1 + C), generator=gen)
    lvl = torch.randint(0, len(LOWRES_ZOOMS), (N, C), generator=gen)
    do = (u[:, 0:1] < p) & (u[:, 1:] < p_per_channel)
    if not bool(do.any()):
        return image
    out = image.clone()
    planes = image.permute(0, 3, 1, 2)                     # (N, C, H, W)
    for li, z in enumerate(LOWRES_ZOOMS):
        n, c = torch.nonzero(do & (lvl == li), as_tuple=True)
        if n.numel():
            n, c = n.to(image.device), c.to(image.device)
            out[n, :, :, c] = lowres_level(planes[n, c], z)
    return out


def gamma_transform(gen: torch.Generator, image: torch.Tensor,
                    p: float = 0.3, rng: Tuple[float, float] = (0.7, 1.5),
                    invert: bool = False,
                    retain_stats: bool = True) -> torch.Tensor:
    """nnU-Net gamma: half the draws come from the sub-1 range when the
    range straddles 1 (batchgenerators GammaTransform), applied to the
    min-max normalized sample; ``retain_stats`` restores its mean and std;
    ``invert`` applies the curve to the negated image."""
    N = image.shape[0]
    u = torch.rand((N, 3), generator=gen)
    low_side = (u[:, 1] < 0.5) & (rng[0] < 1.0)
    hi0 = max(rng[0], 1.0)
    gamma = torch.where(low_side, rng[0] + u[:, 2] * (1.0 - rng[0]),
                        hi0 + u[:, 2] * (rng[1] - hi0))
    gamma = gamma.to(image.device).view(-1, 1, 1, 1)
    dims = (1, 2, 3)
    x = -image if invert else image
    mean = torch.mean(x, dim=dims, keepdim=True)
    std = torch.std(x, dim=dims, keepdim=True, correction=0)
    mn = torch.amin(x, dim=dims, keepdim=True)
    span = torch.clamp(torch.amax(x, dim=dims, keepdim=True) - mn, min=1e-7)
    y = torch.pow((x - mn) / span, gamma) * span + mn
    if retain_stats:
        y = (y - torch.mean(y, dim=dims, keepdim=True)) / torch.clamp(
            torch.std(y, dim=dims, keepdim=True, correction=0),
            min=1e-7) * std + mean
    y = -y if invert else y
    return torch.where(_per_sample_mask(u[:, 0] < p, image), y, image)


def mirror_transform(gen: torch.Generator, image: torch.Tensor,
                     target: torch.Tensor, p_flip: float = 0.5):
    u = torch.rand((image.shape[0], 2), generator=gen)
    for k, ax in ((0, 1), (1, 2)):
        do = u[:, k] < p_flip
        image = torch.where(_per_sample_mask(do, image),
                            torch.flip(image, (ax,)), image)
        target = torch.where(_per_sample_mask(do, target),
                             torch.flip(target, (ax,)), target)
    return image, target


# ---------------------------------------------------------------------------
# the composed recipe
# ---------------------------------------------------------------------------

def augment_batch(gen: torch.Generator, batch: Dict[str, torch.Tensor],
                  p_rot: float = 0.2, p_scale: float = 0.2,
                  p_elastic: float = 0.0, p_noise: float = 0.1,
                  p_blur: float = 0.2, p_brightness: float = 0.15,
                  p_contrast: float = 0.15, p_lowres: float = 0.25,
                  p_gamma_invert: float = 0.1, p_gamma: float = 0.3,
                  p_flip: float = 0.5) -> Dict[str, torch.Tensor]:
    """The full nnU-Net default 2D chain (order as in nnunetv2
    get_training_transforms) on a (N, H, W, C) / (N, H, W, L) batch. The
    spatial stage is batch-partitioned by default (exactly round(N *
    p_any) samples warp, see :func:`spatial_transform_batch`); elastic
    deformation, batches under 8 or ``TS2D_SPATIAL=persample`` draw per
    sample. Every other transform draws per sample."""
    image, target = batch['image'].float(), batch['target']
    n = image.shape[0]
    if (_spatial_mode() == 'partition' and not p_elastic and n >= 8
            and (p_rot or p_scale)):
        image, target = spatial_transform_batch(gen, image, target,
                                                p_rot=p_rot, p_scale=p_scale)
    elif p_rot or p_scale or p_elastic:
        image, target = _spatial_persample(gen, image, target, p_rot=p_rot,
                                           p_scale=p_scale,
                                           p_elastic=p_elastic)
    image = add_gaussian_noise(gen, image, p=p_noise)
    image = blur_transform(gen, image, p=p_blur)
    image = brightness_transform(gen, image, p=p_brightness)
    image = contrast_transform(gen, image, p=p_contrast)
    image = lowres_transform(gen, image, p=p_lowres)
    image = gamma_transform(gen, image, p=p_gamma_invert, invert=True)
    image = gamma_transform(gen, image, p=p_gamma, invert=False)
    image, target = mirror_transform(gen, image, target, p_flip=p_flip)
    return {'image': image, 'target': target}


def augment_pair(gen: torch.Generator, image: torch.Tensor,
                 target: torch.Tensor, **kw):
    """The recipe on one (H, W, C) image and (H, W, L) target (per-sample
    spatial draws); keyword probabilities as :func:`augment_batch`."""
    out = augment_batch(gen, {'image': image[None], 'target': target[None]},
                        **kw)
    return out['image'][0], out['target'][0]
