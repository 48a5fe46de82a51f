"""Minimal pluggable logger.

Equivalent surface to the reference logger (ts2d/core/util/log.py:12-36):
pluggable sinks, a global silent switch, stderr warnings, and ``once=``
deduplication keyed on the caller's location.
"""

from __future__ import annotations

import sys
import traceback

_sinks = [print]
_silent = False
_seen: set = set()


def log_silent(silent: bool = True) -> None:
    global _silent
    _silent = bool(silent)


def is_silent() -> bool:
    return _silent


def _fingerprint() -> tuple:
    # identify the log()/warn() call site: the stack ends
    # [..., caller, log_or_warn, _fingerprint], so the caller is third
    # from the end
    frame = traceback.extract_stack(limit=3)[0]
    return (frame.filename, frame.lineno)


def log(*args, once: bool = False, **kwargs) -> None:
    if _silent:
        return
    if once:
        fp = _fingerprint()
        if fp in _seen:
            return
        _seen.add(fp)
    for sink in _sinks:
        sink(*args, **kwargs)


def warn(*args, once: bool = False, **kwargs) -> None:
    if once:
        fp = _fingerprint()
        if fp in _seen:
            return
        _seen.add(fp)
    kwargs.setdefault('file', sys.stderr)
    print('WARNING:', *args, **kwargs)
