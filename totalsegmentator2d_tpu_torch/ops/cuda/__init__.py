"""Hand-written CUDA kernels for Hopper (sm_90a), their build step and their
plain PyTorch versions."""

import threading

_launch_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the launch count of a kernel
    wrapper. Wrappers run on request threads and on the micro-batcher's
    dispatcher at once, so the read-modify-write goes under a lock."""
    with _launch_lock:
        wrapper.launches += 1
