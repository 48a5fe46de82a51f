"""Device selection and the numerics of the exact (fp32) path."""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Union

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


# The flags below are process-wide, not per thread. Every user holds them
# through one counter: the first holder saves the caller's settings and
# sets the exact ones, the last one out restores them, so a thread that
# leaves never turns TF32 back on under another thread's exact program.
_exact_lock = threading.Lock()
_exact_holders = 0
_exact_saved: tuple = ()


def _acquire_exact() -> None:
    global _exact_holders, _exact_saved
    with _exact_lock:
        if _exact_holders == 0:
            cudnn = torch.backends.cudnn
            _exact_saved = (torch.backends.cuda.matmul.allow_tf32,
                            cudnn.enabled, cudnn.allow_tf32, cudnn.benchmark,
                            cudnn.deterministic)
            torch.backends.cuda.matmul.allow_tf32 = False
            cudnn.enabled, cudnn.allow_tf32 = True, False
            cudnn.benchmark, cudnn.deterministic = False, True
        _exact_holders += 1


def _release_exact() -> None:
    global _exact_holders
    with _exact_lock:
        _exact_holders -= 1
        if _exact_holders == 0:
            cudnn = torch.backends.cudnn
            (torch.backends.cuda.matmul.allow_tf32, cudnn.enabled,
             cudnn.allow_tf32, cudnn.benchmark,
             cudnn.deterministic) = _exact_saved


@contextlib.contextmanager
def exact_numerics():
    """fp32 everywhere, as the reference's exact program: cuDNN convs
    without TF32 (their default on Hopper is TF32, about three decimal
    digits) and with a fixed, batch-independent algorithm choice; cuBLAS
    matmuls without TF32. The caller's settings come back when the last
    holder, in any thread, leaves (see :func:`hold_exact_numerics`)."""
    _acquire_exact()
    try:
        yield
    finally:
        _release_exact()


def hold_exact_numerics() -> Callable[[], None]:
    """Take the exact settings until the returned release is called (it
    may be called more than once; only the first call releases). A CUDA
    engine holds them for as long as it lives, so its programs never
    change process-wide flags per call."""
    _acquire_exact()
    lock, released = threading.Lock(), [False]

    def release() -> None:
        with lock:
            if released[0]:
                return
            released[0] = True
        _release_exact()

    return release
