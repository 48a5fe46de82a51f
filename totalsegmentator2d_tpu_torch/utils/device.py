"""Device selection and the numerics of the exact (fp32) path."""

from __future__ import annotations

import contextlib
from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device a caller asked for; ``None`` means the CUDA card. Without
    a card, ``None`` raises instead of running on the CPU: the CPU path is
    taken only when the caller names it (``device='cpu'``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'No CUDA device is available. Pass device="cpu" to run on '
                'the CPU explicitly.')
        return torch.device('cuda')
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'Device {device} was requested but CUDA is not '
                           f'available')
    return device


@contextlib.contextmanager
def exact_numerics():
    """fp32 everywhere, as the reference's exact program: cuDNN convs
    without TF32 (their default on Hopper is TF32, about three decimal
    digits) and with a fixed, batch-independent algorithm choice; cuBLAS
    matmuls without TF32. Restores the caller's settings on exit."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                        benchmark=False, deterministic=True):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
