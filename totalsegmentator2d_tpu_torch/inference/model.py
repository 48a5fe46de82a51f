"""HostedModel: one anatomical-group model of the database.

Discovers the nnU-Net results tree (plans.json, dataset.json,
fold_N/checkpoint_<name>.pth), parses the spec and loads the fold weights.
Configuration uses the reference tool's dot-key namespace: nnu.configuration,
nnu.folds, nnu.plans, nnu.trainer, nnu.task, nnu.version,
nnu.predict.{augment,stepsize,checkpoint,precision}, nnu.result.colors.

A model that does not fuse into the ensemble of its set runs on its own
per-model engine (inference/engine.py): :meth:`HostedModel.start` loads it
onto the device and runs one warm-up predict at the patch size (the
reference tool's startup dummy predict), on a thread when ``wait=False``
(pair it with :meth:`HostedModel.await_startup`), and
:meth:`HostedModel.apply` segments a 2D image with it.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..io.image import MedicalImage
from ..models.convert import load_checkpoint
from ..models.plans import ModelSpec, parse_model_spec
from ..ops.annotations import set_annotation_meta
from ..utils.files import read_json
from ..utils.logging import warn
from ..utils.params import dict_get
from .engine import InferenceEngine


def find_datasets(root: str, version: Optional[int] = None) -> Dict[int, str]:
    """nnU-Net dataset dirs (Task###_* v1 / Dataset###_* v2) under a
    results root."""
    prefixes = {1: ('Task',), 2: ('Dataset',)}.get(version, ('Task', 'Dataset'))
    found = {}
    for dn in sorted(os.listdir(root)):
        for prefix in prefixes:
            if dn.startswith(prefix):
                tail = dn[len(prefix):].split('_')[0]
                if tail.isdigit():
                    found[int(tail)] = dn
    return found


class HostedModel:
    def __init__(self, config: dict):
        param = config.get('param', {})
        self.id: str = config.get('id', '')
        self.model_name: str = config.get('model', self.id)
        self.group: Optional[str] = config.get('group')
        self.revision = config.get('revision')

        self.version = dict_get(param, 'nnu.version', default=2, dtype=int)
        self.task_id = dict_get(param, 'nnu.task', default=None, dtype=int)
        self.folds = dict_get(param, 'nnu.folds', default=None, dtype=List[int])
        self.plans_name = dict_get(param, 'nnu.plans', default='nnUNetPlans', dtype=str)
        self.configuration = dict_get(param, 'nnu.configuration',
                                      default='2d', dtype=str)
        self.trainer = dict_get(param, 'nnu.trainer', default='nnUNetTrainer',
                                dtype=str)
        self.checkpoint_name = dict_get(param, 'nnu.predict.checkpoint',
                                        default='final', dtype=str)
        self.use_mirroring = dict_get(param, 'nnu.predict.augment',
                                      default=True, dtype=bool)
        self.tile_step_size = dict_get(param, 'nnu.predict.stepsize',
                                       default=None, dtype=float)
        # 'exact' = fp32 everywhere; 'fast' = bf16 conv operands with fp32
        # accumulation and norm statistics
        self.precision = dict_get(param, 'nnu.predict.precision',
                                  default='exact', dtype=str)
        self.result_colors = dict_get(param, 'nnu.result.colors', default='ts2d')
        self._fold_params: Optional[List[Dict[str, torch.Tensor]]] = None
        self._engine: Optional[InferenceEngine] = None
        self._start_lock = threading.Lock()
        self._startup_thread: Optional[threading.Thread] = None
        self._startup_error: Optional[BaseException] = None
        self._configure(config['root'])

    def _configure(self, root: str) -> None:
        tasks = find_datasets(root, version=self.version)
        if not tasks:
            raise RuntimeError(f'No nnU-Net dataset dir found under {root}')
        if self.task_id is None:
            if len(tasks) > 1:
                raise RuntimeError(
                    f'Ambiguous task id; found {sorted(tasks)} — set nnu.task')
            self.task_id = next(iter(tasks))
        if self.task_id not in tasks:
            raise RuntimeError(f'Task {self.task_id} not found under {root}')
        self.task_name = tasks[self.task_id]

        trainer_dir = '__'.join([self.trainer, self.plans_name, self.configuration])
        data_dir = os.path.join(root, self.task_name, trainer_dir)
        if not os.path.isdir(data_dir):
            raise RuntimeError(f'Missing results dir: {data_dir}')
        self.data_dir = data_dir
        self.dataset_json = read_json(os.path.join(data_dir, 'dataset.json'))
        self.plans = read_json(os.path.join(data_dir, 'plans.json'))

        fold_dirs = sorted(
            (int(m.group(1)), os.path.join(data_dir, d))
            for d in os.listdir(data_dir)
            if (m := re.match(r'fold_(\d+)$', d)))
        if self.folds is not None:
            fold_dirs = [(f, p) for f, p in fold_dirs if f in self.folds]
        if not fold_dirs:
            raise RuntimeError(f'No fold directories found under {data_dir}')
        self.fold_dirs = fold_dirs
        self.folds = [f for f, _ in fold_dirs]
        # spec without checkpoint meta first; refined after weights load
        self.spec: ModelSpec = parse_model_spec(
            self.plans, self.dataset_json, configuration=self.configuration)

    # -- identity / metadata ------------------------------------------------

    @property
    def uid(self) -> str:
        return self.id

    @property
    def name(self) -> str:
        return self.model_name

    @staticmethod
    def verify_setup() -> None:
        """Check that this runtime can run the models on the CUDA card: a
        CUDA build of torch with a device, and a kernel launched on it (the
        reference's device check)."""
        if not torch.cuda.is_available():
            raise RuntimeError(
                f'No CUDA device is available (torch {torch.__version__}, '
                f'CUDA {torch.version.cuda}): the models run on the CUDA '
                f'card; pass device="cpu" to run them on the CPU')
        t = torch.ones(1, device='cuda') + 1
        if float(t) != 2.0:
            raise RuntimeError('a CUDA kernel gave a wrong result')

    def get_exts(self) -> list:
        """Supported image file extensions (the reference tool's list)."""
        return ['png', 'bmp', 'nii.gz', 'nrrd', 'mha', 'tif', 'tiff']

    @property
    def multilabel(self) -> bool:
        return self.spec.multilabel

    @property
    def channels(self) -> Dict[int, str]:
        """Channel index -> projection name ('max', 'mean', ...)."""
        return dict(self.spec.channel_names)

    @property
    def labels(self) -> Dict[int, str]:
        return dict(self.spec.labels)

    def get_colors(self) -> Dict[str, object]:
        colors = self.result_colors
        if isinstance(colors, str) or colors is None:
            from ..utils.colors import named_palette
            names = [n for _, n in sorted(self.labels.items())]
            return dict(zip(names, named_palette(colors, len(names))))
        return dict(colors)

    def load_fold_params(self) -> List[Dict[str, torch.Tensor]]:
        """The UNet state dict of every fold (cached). Also refines the spec
        with the checkpoints' mirroring axes."""
        if self._fold_params is not None:
            return self._fold_params
        ckpt_file = f'checkpoint_{self.checkpoint_name}.pth'
        fold_params, axes_seen = [], []
        for f, d in self.fold_dirs:
            path = os.path.join(d, ckpt_file)
            if not os.path.exists(path):
                raise RuntimeError(f'Missing checkpoint: {path}')
            sd, meta = load_checkpoint(path)
            fold_params.append(sd)
            ax = meta.get('inference_allowed_mirroring_axes')
            if ax is not None:
                axes_seen.append((f, tuple(int(a) for a in ax)))
        if axes_seen:
            if len({ax for _, ax in axes_seen}) > 1:
                warn(f'Model {self.id}: folds disagree on '
                     f'inference_allowed_mirroring_axes ({axes_seen}); '
                     f'using fold {axes_seen[0][0]}\'s {axes_seen[0][1]}')
            self.spec = parse_model_spec(
                self.plans, self.dataset_json,
                configuration=self.configuration,
                checkpoint_meta={'inference_allowed_mirroring_axes':
                                 list(axes_seen[0][1])})
        self._fold_params = fold_params
        return fold_params

    def compute_dtype(self) -> Optional[torch.dtype]:
        """``torch.bfloat16`` for precision 'fast' (or 'bf16', 'bfloat16'),
        else ``None`` (exact)."""
        if str(self.precision).lower() in ('fast', 'bf16', 'bfloat16'):
            return torch.bfloat16
        return None

    # -- lifecycle ----------------------------------------------------------

    def _load_engine(self, device=None) -> InferenceEngine:
        return InferenceEngine(
            self.spec, self.load_fold_params(),
            tile_step_size=(self.tile_step_size
                            if self.tile_step_size is not None else 0.5),
            use_mirroring=self.use_mirroring,
            compute_dtype=self.compute_dtype(), device=device)

    def start(self, device=None, wait: bool = True) -> None:
        """Load the per-model engine onto ``device`` (``None`` = the CUDA
        card; ``'cpu'`` runs on the CPU) and run its warm-up predict at the
        patch size, on a thread; ``wait=False`` returns at once (pair it
        with :meth:`await_startup`). A started model stays as it is; a
        start while a startup is pending joins it (``wait=True``) or
        returns (``wait=False``): never a second load."""
        def boot():
            try:
                engine = self._load_engine(device)
                engine.warmup(self.spec.preprocess.patch_size)
                self._engine = engine
            except BaseException as ex:  # noqa: BLE001 (await_startup raises)
                self._startup_error = ex

        with self._start_lock:
            if self._engine is None and self._startup_thread is None:
                self._startup_thread = threading.Thread(target=boot,
                                                        daemon=True)
                self._startup_thread.start()
        if wait:
            self.await_startup()

    def _join_startup(self) -> None:
        with self._start_lock:
            t = self._startup_thread
        if t is not None:
            t.join()
            with self._start_lock:
                if self._startup_thread is t:
                    self._startup_thread = None

    def await_startup(self) -> None:
        """Wait for a pending :meth:`start`; raises RuntimeError (from the
        cause) if it failed."""
        self._join_startup()
        if self._startup_error is not None:
            err, self._startup_error = self._startup_error, None
            raise RuntimeError(f'Model {self.id} failed to start') from err

    def stop(self) -> None:
        """Release the engine and its device memory; a pending startup is
        waited out first, so it cannot bring a stopped model back."""
        self._join_startup()
        self._startup_error = None
        self._engine = None

    @property
    def started(self) -> bool:
        return self._engine is not None

    # -- prediction ----------------------------------------------------------

    def apply(self, img: MedicalImage) -> MedicalImage:
        """Segment a 2D (possibly multi-channel) image: a multilabel one-hot
        vector image (a labelmap for a softmax model) with Segment metadata,
        in the input geometry. Starts the engine on the CUDA card if
        :meth:`start` was not called, and waits for a pending one."""
        if self._engine is None:
            self.start()
        if img.dim != 2:
            raise ValueError(f'apply() expects a 2D image, got dim={img.dim}')
        arr = img.array
        if not img.is_vector:
            arr = arr[..., None]
        if arr.shape[-1] != self.spec.arch.in_channels:
            raise ValueError(
                f'The number of channels in the input image does not match '
                f'the model channel definition '
                f'({self.spec.arch.in_channels} vs {arr.shape[-1]}).')
        spacing_yx = tuple(reversed(img.spacing))  # array-order spacing
        seg = self._engine.predict_array(arr.astype(np.float32), spacing_yx)
        palette = self.get_colors()
        colors = {}
        for n in self.labels.values():
            c = palette.get(n) or palette.get(str(n).lower())
            if c is not None:
                colors[n] = c
        out = img.replace(array=seg, is_vector=self.multilabel, meta={})
        set_annotation_meta(out, names=self.labels, colors=colors)
        return out

    def __repr__(self) -> str:
        return (f'HostedModel({self.id!r}, folds={self.folds}, '
                f'labels={len(self.labels)}, multilabel={self.multilabel})')
