"""Command-line interface:

    python -m totalsegmentator2d_tpu_torch -i <file|dir> -o <dir>
        [--local DB] [--model KEY] [--device cuda|cpu] [--collapse]
        [--save-all] [--silent] [--no-batching] [--trace DIR]

The flags and output naming follow the reference tool. Models come from the
local database (the remote registry is not ported yet). ``--device`` picks
where the models run: the CUDA card by default (an error if there is none),
``cpu`` only when asked for. A directory of cases runs pipelined (read-
ahead, micro-batched dispatch, background export).
"""

from __future__ import annotations

import os
import shutil
from glob import glob
from typing import Iterator, Optional, Tuple

from .io import SUPPORTED_EXTENSIONS
from .utils.config import get_default_model
from .utils.logging import is_silent, log, log_silent, warn

_CITATION = (
    'TS2D is a research tool. It is NOT validated for clinical use and should '
    'NOT be used for medical diagnosis or treatment.\n'
    'Please cite the following paper when using TS2D:\n'
    'Sabrowsky-Hirsch, B., Alshenoudy, A., Thumfart, S., & Giretzlehner, M. '
    '(2025, July).\n'
    'TotalSegmentator 2D: A Tool for Rapid Anatomical Structure Analysis.\n'
    'In Annual Conference on Medical Image Understanding and Analysis '
    '(pp. 32-43). Cham: Springer Nature Switzerland.'
)


def _enumerate_cases(src: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, path) for the input file, or for every supported file
    of the input directory (others are skipped)."""
    if not os.path.exists(src):
        raise FileNotFoundError(f'Source does not exist: {src}')
    isdir = os.path.isdir(src)
    paths = sorted(glob(os.path.join(src, '*.*'))) if isdir else [src]
    for fp in paths:
        name, _, ext = os.path.basename(fp).partition('.')
        if not os.path.isfile(fp) or ext.lower() not in SUPPORTED_EXTENSIONS:
            if isdir:
                continue
            raise ValueError(f'Unsupported input {fp!r} (the PyTorch package '
                             f'reads: {", ".join(SUPPORTED_EXTENSIONS)})')
        yield name, fp


def ts2d_run(src: str, dest: str, model: Optional[str] = None,
             collapse: bool = False,
             save_all: bool = False, silent: bool = False,
             local: Optional[str] = None, device=None,
             trace: Optional[str] = None, batching: bool = True) -> None:
    """Run TS2D on one image or a directory of images. More than one case
    runs through :class:`~.inference.pipeline.ScanPipeline` (read-ahead,
    up to 8 scans in flight for the micro-batcher, background export).
    ``trace`` writes a torch.profiler trace of the run into that directory;
    ``batching=False`` turns micro-batching off for bitwise run-to-run
    consistency (see TS2D)."""
    from .api import TS2D
    from .utils.trace import device_trace

    model = get_default_model() if model is None else model
    was_silent = is_silent()
    log_silent(silent)
    try:
        bar = '#' * shutil.get_terminal_size(fallback=(120, 20)).columns
        log(f'\n{bar}\n{_CITATION}\n{bar}\n')
        with TS2D(key=model, use_remote=False, local=local, device=device,
                  batching=batching) as tool, device_trace(trace):
            cases = list(_enumerate_cases(src))
            n = len(cases)
            if not cases:
                warn(f'No supported input found in {src}')
            save_kwargs = dict(dest=dest,
                               models='all' if save_all else 'final',
                               targets=['segmentation', 'projection'])
            if n > 1:
                from .inference.pipeline import ScanPipeline
                ScanPipeline(tool).run(cases, collapse=collapse,
                                       save_kwargs=save_kwargs)
            elif n == 1:
                name, path = cases[0]
                log(f'[1/1] Processing: {name}')
                tool.predict(path, collapse=collapse).save(name=name,
                                                           **save_kwargs)
    finally:
        log_silent(was_silent)


def ts2d_entry_point() -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description='Runs TotalSegmentator2D (TS2D, PyTorch/CUDA build) on '
                    'images or directories of images to automatically '
                    'segment anatomical structures.')
    parser.add_argument('--src', '-i', '--input', type=str, required=True,
                        help='Input image file or directory (nrrd).')
    parser.add_argument('--dest', '-o', '--output', type=str, required=True,
                        help='Output directory for results.')
    parser.add_argument('--model', type=str, default=None,
                        help="Model key for prediction, defaults to "
                             "'ts2d-v2-ep4000b2'.")
    parser.add_argument('--collapse', action='store_true',
                        help='Collapse projected images to 2D. This removes '
                             'the 3D geometrical information.')
    parser.add_argument('--save-all', action='store_true',
                        help='In addition to the final result, also saves '
                             'results for each individual model.')
    parser.add_argument('--silent', action='store_true',
                        help='Hides any unnecessary output.')
    parser.add_argument('--local', type=str, default=None,
                        help='Override the local model database root '
                             '(defaults to ~/.ts2d/models).')
    parser.add_argument('--device', type=str, default=None,
                        help="Where the models run: 'cuda' (the default; an "
                             "error without a CUDA device) or 'cpu'.")
    parser.add_argument('--trace', type=str, default=None,
                        help='Write a torch.profiler trace of the run to '
                             'this directory (open it in Perfetto).')
    parser.add_argument('--no-batching', action='store_true',
                        help='Disable micro-batched dispatch (bitwise '
                             'run-to-run consistency; lower directory-mode '
                             'throughput).')
    from . import __version__
    parser.add_argument('--version', action='version',
                        version=f'ts2d (PyTorch/CUDA) {__version__}')

    args = parser.parse_args()
    ts2d_run(src=args.src, dest=args.dest, model=args.model,
             collapse=args.collapse,
             save_all=args.save_all, silent=args.silent, local=args.local,
             device=args.device, trace=args.trace,
             batching=not args.no_batching)
