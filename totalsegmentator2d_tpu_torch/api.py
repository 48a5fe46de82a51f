"""Public API: the TS2D orchestrator and its Result container.

The same surface as the reference tool: ``TS2D(key=...)``, ``predict()``,
``Result.save()`` with its output naming matrix. A model set whose models
agree on their predict settings and are all multilabel (the published
ts2d/tsxr sets) runs as ONE fused ensemble (inference/ensemble_engine.py);
any other set runs model by model on per-model engines
(inference/engine.py) and merges the results, as the reference does. Both
run on the CUDA card, or on the CPU when the caller passes
``device='cpu'``, at the models' precision ('exact' fp32 or 'fast' bf16).

A fused set also serves: ``predict_async`` / ``finish_predict`` split a
predict into its host half (projection, crop, dispatch) and its device
half, and with ``batching=True`` (the default) concurrent or in-flight
predictions coalesce into micro-batched programs of up to 8 scans
(inference/batching.py); ScanPipeline and the HTTP server (serve.py) are
built on these. With ``pad_quantum=N`` a fused set serves every crop
through the bucket program of its shape bucket (inference/bucket.py).

``predict`` reads NRRD, NIfTI, MetaImage and DICOM inputs (a series
directory, one file, or a zipped series; io/__init__.py). Models come from
the local database; with ``use_remote`` (the default) a model missing from
it is downloaded from the registry first (inference/zoo.py).
``Result.save`` writes NRRD, NIfTI or MetaImage files and PNG visuals
(``content='visual'|'all'``), the visuals rendered on the tool's device.
"""

from __future__ import annotations

import os
import traceback
from typing import Dict, List, Optional, Union

import numpy as np

from .inference.database import URLDataBase, decompose_model_key
from .inference.ensemble_engine import EnsembleEngine
from .inference.model import HostedModel
from .inference.zoo import Zoo
from .io import MedicalImage, read_image, write_image
from .ops.annotations import combine_segmentations, set_annotation_meta
from .ops.geometry import reduce_dimensions, reorient, restore_dimension
from .ops.projection import project_multi
from .ops.visual import create_visual
from .utils.config import get_label_colors, get_shared_urls
from .utils.device import resolve_device
from .utils.files import mkdirs
from .utils.logging import log, warn
from .utils.params import as_list, as_set


class TS2D:
    """Segment anatomical structures in CT scans (via coronal projection) or
    native 2D X-rays with an ensemble of 2D multilabel U-Nets.

    :param key: model key, resolved through the alias map and the local
        database (default 'ts2d' -> ts2d-v2-ep4000b2, all five groups)
    :param use_remote: resolve keys through the remote registry and
        download a model that the local database lacks
    :param fetch_remote: refresh the registry from the upstream repository
        (else, and on any failure, the packaged ``shared.json``)
    :param local: the local model database root (default ~/.ts2d/models)
    :param param: extra dot-key parameters merged into every model config
    :param device: ``None`` = the CUDA card (raises if there is none);
        ``'cpu'`` runs on the CPU
    :param batching: coalesce concurrent or in-flight predictions of a
        fused set into micro-batched programs (inference/batching.py), the
        throughput mode of serving and directory inputs. The batched
        program runs other conv batch sizes and one-pass norm statistics,
        which flips borderline sigmoid pixels, so results can depend on
        load; pass False for bitwise run-to-run consistency.
    :param pad_quantum: quantized-shape serving: each scan's cropped
        projection rides the shape bucket of its size rounded up to a
        multiple of N per axis, and one bucket program serves every size
        inside it (the scan's true extent is data: tile layout, symmetric
        padding and resample matrices follow it), so scans of different
        sizes share programs and micro-batches. Masks match the exact
        programs up to borderline pixels. None (default) = the exact
        per-shape programs. A set that does not fuse ignores it.
    """

    def __init__(self, key: str = 'ts2d', use_remote: bool = True,
                 fetch_remote: bool = True, local: Optional[str] = None,
                 param: Optional[dict] = None, device=None,
                 batching: bool = True, pad_quantum: Optional[int] = None):
        self.device = resolve_device(device)
        if pad_quantum is not None and int(pad_quantum) < 1:
            raise ValueError('pad_quantum must be >= 1')
        self._pad_quantum = pad_quantum
        self._batching = bool(batching)
        model_param = {'nnu.result.colors': get_label_colors()}
        if param:
            model_param.update(param)

        remote = URLDataBase(get_shared_urls(fetch_remote)) if use_remote \
            else False
        self.zoo = Zoo(remote=remote, local=local)
        self.models: Dict[str, HostedModel] = {}
        # set before any model loads: a constructor that fails midway still
        # reaches __del__ -> close()
        self._fused: Optional[EnsembleEngine] = None
        ids = self.zoo.resolve(key, unique_model=True)
        if not ids:
            raise RuntimeError(f'No models were resolved for key: {key}')
        if len(ids) > 1:
            log(f"The model key '{key}' was resolved to {len(ids)} models: "
                f"{', '.join(ids)}.")
        for id_ in ids:
            try:
                model = self.zoo.load(id_, param=model_param)
            except Exception as ex:
                # the cause's message rides along: a failed download names
                # its URL
                raise RuntimeError(
                    f'Failed to load model {id_}'
                    + (f' (resolved from {key})' if key != id_ else '')
                    + f': {ex}') from ex
            if not model.multilabel:
                warn(f'The loaded model {id_} is not configured for '
                     f'multilabel inference - this should not be the case '
                     f'in TS2D and may lead to unexpected results.')
            self.models[id_] = model
        self._fused = self._build_fused()

    def _build_fused(self) -> Optional[EnsembleEngine]:
        """The fused ensemble, or None when the models do not fuse: not all
        multilabel, other input channels, or disagreeing predict settings
        (step size, mirroring and its axes, precision) or architectures.
        Those sets run on per-model engines, which start here."""
        models = list(self.models.values())
        for m in models:
            m.load_fold_params()  # also refines spec with mirror axes
        ref = models[0]
        fuse = (
            all(m.spec.multilabel for m in models)
            and all(m.channels == ref.channels for m in models)
            and all(m.tile_step_size == ref.tile_step_size
                    and m.use_mirroring == ref.use_mirroring
                    and m.compute_dtype() == ref.compute_dtype()
                    and m.spec.allowed_mirroring_axes
                    == ref.spec.allowed_mirroring_axes for m in models))
        engine = None
        if fuse:
            try:
                engine = EnsembleEngine(
                    [m.spec for m in models],
                    [m.load_fold_params() for m in models],
                    tile_step_size=(ref.tile_step_size
                                    if ref.tile_step_size is not None else 0.5),
                    use_mirroring=ref.use_mirroring,
                    compute_dtype=ref.compute_dtype(), device=self.device,
                    # concurrent requests coalesce into one batched
                    # program; a lone request runs the solo program
                    auto_batch=8 if self._batching else None,
                    pad_quantum=self._pad_quantum)
            except ValueError as ex:  # preprocessing or architecture differ
                log(f'Fused ensemble unavailable ({ex}); using per-model '
                    f'engines.')
        else:
            log('Fused ensemble unavailable (models disagree on predict '
                'settings or are not all multilabel); using per-model engines.')
        if engine is None:
            if self._pad_quantum is not None:
                warn('pad_quantum requires the fused ensemble engine; the '
                     'per-model engines run the exact per-shape programs')
            for m in models:   # every model loads and warms up at once
                m.start(self.device, wait=False)
            for m in models:
                m.await_startup()
        return engine

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> 'TS2D':
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()

    def close(self) -> None:
        """Release the models and their device memory, and stop the fused
        engine's micro-batch dispatcher."""
        for model in self.models.values():
            model.stop()
        self.models = {}
        if self._fused is not None:
            self._fused.close()
        self._fused = None

    def __del__(self):
        if getattr(self, 'models', None) or getattr(self, '_fused', None):
            warn('The TS2D instance is being deleted without calling close() '
                 '- cleaning up all models. Call close() explicitly before '
                 'deleting the instance to avoid concurrency issues.')
            try:
                self.close()
            except Exception:
                traceback.print_exc()

    # -- prediction -------------------------------------------------------

    @staticmethod
    def _model_colors(model: HostedModel) -> dict:
        palette = model.get_colors()
        colors = {}
        for _, name in model.labels.items():
            c = palette.get(name) or palette.get(str(name).lower())
            if c is not None:
                colors[name] = c
        return colors

    def predict(self, input: Union[MedicalImage, str], collapse: bool = False,
                merge: bool = True) -> 'TS2D.Result':
        """Predict the segmentation for an image (path or MedicalImage).

        3D inputs are reoriented to RAI and projected on the host (one
        channel per model input: MIP, AIP). A fused set then runs the
        ensemble once on the cropped 2D image, and per-model results are
        channel slices of the merged output; any other set runs each model
        on its own engine and merges their segmentations.

        :param collapse: collapse outputs to true 2D, discarding the 3D
            size-1-axis geometry
        :param merge: merge the per-group segmentations into one multilabel
            image (117 channels for ts2d-v2)
        """
        input = self._input(input)
        if self._fused is not None:
            return self._predict_fused_finish(
                self._predict_fused_dispatch(input, collapse, merge))
        cache: dict = {}
        result = {'models': {
            id_: self._predict_model(id_, model, input, collapse, cache)
            for id_, model in self.models.items()}}
        if merge:
            segs = [r['segmentation'] for r in result['models'].values()]
            result['segmentation'] = (segs[0] if len(segs) == 1
                                      else combine_segmentations(segs))
        result['input'] = input
        if cache.get('projections'):
            result['projections'] = cache['projections']
        return TS2D.Result(result, device=self.device)

    def _input(self, input: Union[MedicalImage, str]) -> MedicalImage:
        if isinstance(input, str):
            input = read_image(input)
        if not isinstance(input, MedicalImage):
            raise RuntimeError(
                f'input must be a string path or a MedicalImage, found: '
                f'{type(input).__name__}')
        if not self.models:
            raise RuntimeError('This TS2D instance is closed')
        return input

    @property
    def supports_async(self) -> bool:
        """True when :meth:`predict_async` dispatches without waiting (a
        fused set); False when it runs a blocking predict. Pipelines size
        their in-flight window by it."""
        return self._fused is not None

    def predict_async(self, input: Union[MedicalImage, str],
                      collapse: bool = False, merge: bool = True):
        """Dispatch a prediction without waiting for the card; returns a
        handle for :meth:`finish_predict`. Several scans in flight let the
        fused engine's micro-batcher coalesce them into one program
        (ScanPipeline does this for directory inputs). A set that does not
        fuse runs a blocking predict here."""
        input = self._input(input)
        if self._fused is None:
            return ('sync', self.predict(input, collapse=collapse,
                                         merge=merge))
        return ('fused', self._predict_fused_dispatch(input, collapse, merge))

    def finish_predict(self, handle) -> 'TS2D.Result':
        """Wait for a :meth:`predict_async` handle and return the Result."""
        kind, data = handle
        if kind == 'sync':
            return data
        return self._predict_fused_finish(data)

    @staticmethod
    def _model_input(original: MedicalImage, id_: str, channels: list,
                     cache: dict) -> MedicalImage:
        """The image a model reads. A 3D input is reoriented to RAI (once)
        and projected along the coronal axis, one projection per channel
        mode, each computed once and kept in ``cache['projections']``; a 2D
        input is used as it is, its channels kept as ``ch<i>``."""
        if not channels:
            raise RuntimeError(
                f'Model {id_} does not have a channel definition, cannot '
                f'project the input image.')
        projections = cache.setdefault('projections', {})
        if original.actual_dimension() > 2:
            if 'oriented' not in cache:
                cache['oriented'] = reorient(original, 'RAI')
            todo = [n for _, n in channels if n not in projections]
            projections.update(zip(todo, project_multi(
                cache['oriented'], todo, axis='coronal')))
            ch_list = [projections[n] for _, n in channels]
            return MedicalImage.compose(ch_list) if len(ch_list) > 1 \
                else ch_list[0]
        if len(channels) != original.ncomponents:
            raise RuntimeError(
                f'The number of channels in the input image does not '
                f'match the models channel definition '
                f'({len(channels)} vs {original.ncomponents}).')
        projections.update((f'ch{i}', ch) for i, ch in
                           enumerate(original.split_channels()))
        return original

    def _predict_model(self, id_: str, model: HostedModel,
                       original: MedicalImage, collapse: bool,
                       cache: dict) -> dict:
        """One model of a set that does not fuse, on its own engine."""
        channels = sorted(model.channels.items(), key=lambda kv: kv[0])
        model_input = self._model_input(original, id_, channels, cache)
        native_2d = model_input.dim < 3
        input2d = model_input if native_2d else reduce_dimensions(model_input)
        seg = model.apply(input2d)
        if not (collapse or native_2d):
            seg = restore_dimension(seg, model_input)
        mname, mgroup = decompose_model_key(id_)
        return {'id': id_, 'model': mname, 'group': mgroup,
                'revision': model.revision,
                'input': input2d if collapse else model_input,
                'segmentation': seg}

    def _predict_fused_dispatch(self, original: MedicalImage, collapse: bool,
                                merge: bool):
        """The host half of the fused set: projection, crop and dispatch of
        one ensemble run on the 2D image, without waiting for the card.
        Returns the context :meth:`_predict_fused_finish` takes."""
        cache: dict = {}
        models = list(self.models.items())
        channels = sorted(models[0][1].channels.items(), key=lambda kv: kv[0])
        model_input = self._model_input(original, models[0][0], channels,
                                        cache)
        native_2d = model_input.dim < 3
        input2d = model_input if native_2d else reduce_dimensions(model_input)
        arr = input2d.array
        if not input2d.is_vector:
            arr = arr[..., None]
        spacing_yx = tuple(reversed(input2d.spacing))
        handle = self._fused.predict_array_async(
            np.ascontiguousarray(arr, np.float32), spacing_yx)
        return (handle, original, model_input, input2d, cache, collapse,
                merge)

    def _predict_fused_finish(self, ctx) -> 'TS2D.Result':
        """The device half: wait for the ensemble's result and assemble the
        Result; each model's segmentation is its slice of the merged
        channels."""
        (handle, original, model_input, input2d, cache, collapse,
         merge) = ctx
        models = list(self.models.items())
        merged2d = self._fused.finish_array(handle)
        native_2d = model_input.dim < 3
        per_model_input = input2d if collapse else model_input
        result: dict = {'models': {}}
        offset = 0
        merged_names: dict = {}
        merged_colors: dict = {}
        for id_, model in models:
            n = model.spec.arch.out_channels - (0 if model.multilabel else 1)
            seg_arr = np.ascontiguousarray(merged2d[..., offset:offset + n])
            seg = input2d.replace(array=seg_arr, is_vector=True, meta={})
            colors = self._model_colors(model)
            set_annotation_meta(seg, names=model.labels, colors=colors)
            if not (collapse or native_2d):
                seg = restore_dimension(seg, model_input)
            mname, mgroup = decompose_model_key(id_)
            result['models'][id_] = {
                'id': id_, 'model': mname, 'group': mgroup,
                'revision': model.revision, 'input': per_model_input,
                'segmentation': seg,
            }
            for _, name in sorted(model.labels.items()):
                merged_names[len(merged_names) + 1] = name
                if name in colors:
                    merged_colors[name] = colors[name]
            offset += n

        if merge:
            seg_all = input2d.replace(array=merged2d, is_vector=True, meta={})
            set_annotation_meta(seg_all, names=merged_names,
                                colors=merged_colors)
            if not (collapse or native_2d):
                seg_all = restore_dimension(seg_all, model_input)
            result['segmentation'] = seg_all
        result['input'] = original
        if cache.get('projections'):
            result['projections'] = cache['projections']
        return TS2D.Result(result, device=self.device)

    # -- results ------------------------------------------------------------

    class Result:
        """A prediction's images; ``device`` is where :meth:`save` renders
        visuals (the tool's device; None = the CUDA card)."""

        def __init__(self, data: dict, device=None):
            self.data = data
            self.device = device

        @property
        def models(self) -> List[str]:
            return sorted(self.data.get('models', {}).keys())

        def get_input(self, model: Optional[str] = None):
            if model is not None:
                return self.data.get('models', {}).get(model, {}).get('input')
            return self.data.get('input')

        def get_segmentation(self, model: Optional[str] = None):
            if model is not None:
                return self.data.get('models', {}).get(model, {}).get('segmentation')
            return self.data.get('segmentation')

        def get_projection(self, channel: Optional[str] = None):
            projections = self.data.get('projections', {})
            if channel is not None:
                return projections.get(channel)
            return projections

        def get_statistics(self, model: Optional[str] = None) -> dict:
            """Per-label statistics of a segmentation: {name: {value,
            exists, count, mm, color}}."""
            from .ops.annotations import get_annotation_labels
            seg = self.get_segmentation(model)
            if seg is None:
                return {}
            return get_annotation_labels(seg, counts=True)

        def save(self, dest: str, name: str = 'result', ext: str = 'nrrd',
                 models: Union[str, List[str]] = 'final',
                 targets: Union[str, List[str]] = 'all',
                 content: str = 'all',
                 naming: str = 'group') -> None:
            """Export results with the reference's naming matrix
            (tool.py:235-311): ``<name>[-<group>][.seg].<ext>``,
            projections ``<name>_<channel>.<ext>``, PNG visuals beside
            them as ``.png``.

            :param ext: 'nrrd', 'nii', 'nii.gz' or 'mha' (not 'png')
            :param models: 'final', 'all', or explicit model ids
            :param targets: subset of {'input','segmentation','projection'} or 'all'
            :param content: 'file', 'visual' or 'all'
            :param naming: 'group' (default) or 'model'
            """
            if ext.lower() == 'png':
                raise ValueError("PNG is not a valid export format for the "
                                 "'file' content type.")
            if naming not in ('group', 'model'):
                raise ValueError(f"Invalid naming scheme '{naming}', must be "
                                 f"'group' or 'model'.")
            if content not in ('file', 'visual', 'all'):
                raise ValueError(f"Invalid export type '{content}'.")
            contents = {'visual', 'file'} if content == 'all' else {content}

            model_set = as_set(str(t).strip().lower() for t in as_list(models))
            if 'all' in model_set:
                model_set |= set(self.models) | {None}
            if 'final' in model_set:
                model_set |= {None}
            model_set -= {'all', 'final'}
            target_set = as_set(str(t).strip().lower() for t in as_list(targets))

            def _filename(base, key):
                if key is not None and naming == 'group':
                    return f'{base}-{decompose_model_key(key)[1]}'
                return base if key is None else f'{base}-{key}'

            def _visual(img, **kwargs):
                return create_visual(img, device=self.device, **kwargs)

            def _export(img: MedicalImage, base: str, suffix: str = '',
                        labels=False):
                if 'file' in contents:
                    write_image(img, os.path.join(dest, f'{base}{suffix}.{ext}'))
                if 'visual' not in contents:
                    return
                if labels:
                    vis = _visual(img, labels=True, axis='coronal')
                    write_image(vis, os.path.join(dest, f'{base}{suffix}.png'))
                    return
                nch = img.ncomponents
                for cidx, ch in enumerate(img.split_channels()):
                    vis = _visual(ch, labels=False, axis='coronal')
                    fn = (f'{base}{suffix}.png' if nch == 1
                          else f'{base}-ch{cidx}{suffix}.png')
                    write_image(vis, os.path.join(dest, fn))

            mkdirs(dest)
            if {'all', 'input'} & target_set:
                for key in model_set:
                    img = self.get_input(key)
                    if img is not None:
                        _export(img, _filename(name, key))
            if {'all', 'segmentation'} & target_set:
                for key in model_set:
                    img = self.get_segmentation(key)
                    if img is not None:
                        _export(img, _filename(name, key), suffix='.seg',
                                labels=True)
            if {'all', 'projection'} & target_set:
                for channel, img in self.get_projection().items():
                    base = f'{name}_{channel}'
                    if 'file' in contents:
                        write_image(img, os.path.join(dest, f'{base}.{ext}'))
                    if 'visual' in contents:
                        write_image(_visual(img), os.path.join(dest, f'{base}.png'))
