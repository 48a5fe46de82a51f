"""Command-line interface:

    python -m totalsegmentator2d_tpu_torch -i <file|dir> -o <dir>
        [--local DB] [--model KEY] [--no-remote] [--no-fetch]
        [--device cuda|cpu] [--collapse] [--visualize] [--save-all]
        [--silent] [--no-batching] [--trace DIR]

The flags and output naming follow the reference tool. Models come from the
local database, downloaded from the registry on a miss unless
``--no-remote`` is given; ``--no-fetch`` reads the packaged registry
instead of the upstream one. The input is an image file (NRRD, NIfTI,
MetaImage, one DICOM file or a zipped DICOM series), a DICOM series
directory, or a directory of such cases: its supported files and its
series subdirectories (loose DICOM slices beside other cases are skipped
with a warning). ``--visualize`` adds PNG visuals beside the files.
``--device`` picks where the models run: the CUDA card by default (an
error if there is none), ``cpu`` only when asked for. A directory of cases
runs pipelined (read-ahead, micro-batched dispatch, background export).
"""

from __future__ import annotations

import os
import shutil
from glob import glob
from typing import Iterator, Optional, Tuple

from .io import SUPPORTED_EXTENSIONS
from .io.dicom import DICOM_EXTENSIONS, is_dicom_dir
from .utils.config import get_default_model
from .utils.logging import is_silent, log, log_silent, warn

_DICOM_EXTENSIONS = tuple(e[1:] for e in DICOM_EXTENSIONS)
# a DICOM series is a directory case (see _enumerate_cases); a single
# DICOM file also reads, and a .zip holds one zipped series
_SUPPORTED = SUPPORTED_EXTENSIONS + _DICOM_EXTENSIONS + ('zip',)

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
    of the input directory (others are skipped). A directory of DICOM slice
    files is one case (the series); so is each DICOM series subdirectory of
    the input directory. Cases of one stem (a.nrrd and a.nii, or a series
    directory 'case1' beside case1.nii.gz) get distinct names."""
    if not os.path.exists(src):
        raise FileNotFoundError(f'Source does not exist: {src}')
    seen: dict = {}

    def _uniq(name: str, path: str) -> str:
        # same-stem cases must not overwrite each other's outputs in dest:
        # the later one is renamed
        if name not in seen:
            seen[name] = 1
            return name
        new = name
        while new in seen:
            seen[name] += 1
            new = f'{name}-{seen[name]}'
        seen[new] = 1
        warn(f"duplicate case name '{name}' ({path}): outputs would "
             f"overwrite an earlier case's — writing this one as '{new}'")
        return new

    if is_dicom_dir(src):
        yield os.path.basename(os.path.normpath(src)), src
        return
    isdir = os.path.isdir(src)
    if isdir:
        for sub in sorted(glob(os.path.join(src, '*'))):
            if is_dicom_dir(sub):
                yield _uniq(os.path.basename(os.path.normpath(sub)), sub), sub
    paths = sorted(glob(os.path.join(src, '*.*'))) if isdir else [src]
    for fp in paths:
        name, _, ext = os.path.basename(fp).partition('.')
        if not os.path.isfile(fp) or ext.lower() not in _SUPPORTED:
            if isdir:
                continue
            raise ValueError(f'Unsupported input {fp!r} (the PyTorch package '
                             f'reads: {", ".join(_SUPPORTED)} and DICOM '
                             f'series directories)')
        if isdir and ext.lower() in _DICOM_EXTENSIONS:
            # a loose slice file in a mixed directory is almost always one
            # slice of a series: segmenting it alone (dz = 1) would give a
            # near-meaningless result
            warn(f'skipping loose DICOM file {os.path.basename(fp)} in a '
                 f'mixed directory (likely one slice of a series) — pass the '
                 f'series directory, or the file itself, as --src to segment '
                 f'it', once=True)
            continue
        yield _uniq(name, fp), fp


def ts2d_run(src: str, dest: str, model: Optional[str] = None,
             use_remote: bool = True, fetch_remote: bool = True,
             collapse: bool = False, visualize: bool = True,
             save_all: bool = False, silent: bool = False,
             local: Optional[str] = None, device=None,
             trace: Optional[str] = None, batching: bool = True) -> None:
    """Run TS2D on one image or a directory of images. More than one case
    runs through :class:`~.inference.pipeline.ScanPipeline` (read-ahead,
    up to 8 scans in flight for the micro-batcher, background export).
    ``trace`` writes a torch.profiler trace of the run into that directory
    (host ops, the port's spans of utils/trace.py and the card's kernels);
    ``batching=False`` turns micro-batching off for bitwise run-to-run
    consistency (see TS2D). ``visualize`` writes PNG visuals beside the
    files (the CLI's ``--visualize``)."""
    from .api import TS2D
    from .utils.trace import device_trace

    model = get_default_model() if model is None else model
    was_silent = is_silent()
    log_silent(silent)
    try:
        bar = '#' * shutil.get_terminal_size(fallback=(120, 20)).columns
        log(f'\n{bar}\n{_CITATION}\n{bar}\n')
        with TS2D(key=model, use_remote=use_remote,
                  fetch_remote=fetch_remote, local=local, device=device,
                  batching=batching) as tool, device_trace(trace):
            cases = list(_enumerate_cases(src))
            n = len(cases)
            if not cases:
                warn(f'No supported input found in {src}')
            save_kwargs = dict(dest=dest,
                               models='all' if save_all else 'final',
                               content='all' if visualize else 'file',
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
                        help='Input image file or directory (nrrd, nhdr, '
                             'nii, nii.gz, mha, mhd, dcm, dicom, ima, zip, '
                             'or a DICOM series directory).')
    parser.add_argument('--dest', '-o', '--output', type=str, required=True,
                        help='Output directory for results.')
    parser.add_argument('--model', type=str, default=None,
                        help="Model key for prediction, defaults to "
                             "'ts2d-v2-ep4000b2'.")
    parser.add_argument('--no-remote', action='store_true',
                        help='Disable remote model download. Models must be '
                             'available locally.')
    parser.add_argument('--no-fetch', action='store_true',
                        help='Do not fetch the latest model URLs from the '
                             'remote repository; use the packaged '
                             'shared.json.')
    parser.add_argument('--collapse', action='store_true',
                        help='Collapse projected images to 2D. This removes '
                             'the 3D geometrical information.')
    parser.add_argument('--visualize', action='store_true',
                        help='Additionally generate PNG visualizations of '
                             'the results.')
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
                             'this directory (open it in Perfetto): the '
                             'host ops and the port\'s spans of every '
                             'thread, from predict_async to the Result, '
                             'and the card\'s kernels.')
    parser.add_argument('--no-batching', action='store_true',
                        help='Disable micro-batched dispatch (bitwise '
                             'run-to-run consistency; lower directory-mode '
                             'throughput).')
    from . import __version__
    parser.add_argument('--version', action='version',
                        version=f'ts2d (PyTorch/CUDA) {__version__}')

    args = parser.parse_args()
    ts2d_run(src=args.src, dest=args.dest, model=args.model,
             use_remote=not args.no_remote, fetch_remote=not args.no_fetch,
             collapse=args.collapse, visualize=args.visualize,
             save_all=args.save_all, silent=args.silent, local=args.local,
             device=args.device, trace=args.trace,
             batching=not args.no_batching)
