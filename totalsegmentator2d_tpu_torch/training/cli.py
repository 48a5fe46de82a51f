"""``ts2d-torch-train``: turnkey training from an nnU-Net-raw-style 2D
dataset (the reference package's ``ts2d-train``, training/cli.py).

Point the command at a raw dataset directory and it fingerprints, plans,
preprocesses, trains on the card (optionally with the full on-device
nnU-Net augmentation recipe), cross-validates over folds, and exports a
zoo-compatible model directory, loadable by ``TS2D(key=...,
local=<output>)`` of either package and by the original nnU-Net pipeline
(checkpoints are torch state dicts). ``--device cpu`` trains on the CPU;
``--mesh`` (training over a device mesh) comes with the parallel slice.

Dataset layout (nnU-Net raw, 2D)::

    dataset/
      dataset.json          channel_names, labels, file_ending, multilabel
      imagesTr/
        case07.nrrd           one vector image per case, or
        case07_0000.png        one file per channel (nnU-Net's _XXXX suffix)
      labelsTr/
        case07.nrrd           one-hot vector (multilabel) or labelmap

Images may be any format ``io.read_image`` reads (NRRD, NIfTI, MetaImage,
PNG, BMP, TIFF); ``file_ending`` in dataset.json names it.

Example::

    ts2d-torch-train -d ./Dataset501_hearts -o ~/.ts2d/models \\
        --model ts2d-mine --group cardiac --steps 2000 --augment --bf16
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io import read_image
from ..io.image import MedicalImage
from ..utils.device import resolve_device
from ..utils.files import read_json
from ..utils.logging import log, log_silent

_CHANNEL_RE = re.compile(r'^(?P<stem>.+)_(?P<ch>\d{4})$')


def _strip_ext(name: str, ending: str) -> Optional[str]:
    return name[:-len(ending)] if name.endswith(ending) else None


def load_raw_dataset(root: str) -> Tuple[List[Tuple[MedicalImage, MedicalImage]],
                                         Dict[int, str], Dict[str, int], bool,
                                         str]:
    """Read an nnU-Net-raw 2D dataset directory.

    Returns (cases, channel_names, labels (name -> value, background
    dropped), multilabel, file_ending). Per-channel ``_0000`` image files
    compose into one vector image per case.
    """
    ds = read_json(os.path.join(root, 'dataset.json'))
    ending = ds.get('file_ending', '.nrrd')
    channel_names = {int(k): str(v)
                     for k, v in ds.get('channel_names', {'0': 'image'}).items()}
    labels_full = {str(k): int(v) for k, v in ds.get('labels', {}).items()}
    labels = {k: v for k, v in labels_full.items() if v != 0}
    if not labels:
        raise ValueError('dataset.json declares no foreground labels')
    multilabel = bool(ds.get('multilabel', True))

    img_dir = os.path.join(root, 'imagesTr')
    lbl_dir = os.path.join(root, 'labelsTr')
    if not os.path.isdir(img_dir) or not os.path.isdir(lbl_dir):
        raise FileNotFoundError(f'{root} must contain imagesTr/ and labelsTr/')

    by_case: Dict[str, Dict[int, str]] = {}
    for fn in sorted(os.listdir(img_dir)):
        stem = _strip_ext(fn, ending)
        if stem is None:
            continue
        m = _CHANNEL_RE.match(stem)
        if m:
            by_case.setdefault(m['stem'], {})[int(m['ch'])] = \
                os.path.join(img_dir, fn)
        else:
            by_case.setdefault(stem, {})[-1] = os.path.join(img_dir, fn)

    n_ch = len(channel_names)
    n_labels = max(labels.values())
    cases = []
    for stem in sorted(by_case):
        chans = by_case[stem]
        if -1 in chans:  # single (possibly vector) file
            img = read_image(chans[-1])
            arr = img.array if img.is_vector else img.array[..., None]
        else:
            if sorted(chans) != list(range(n_ch)):
                raise ValueError(
                    f'case {stem}: channel files {sorted(chans)} do not '
                    f'match dataset.json channel_names (need 0..{n_ch - 1})')
            parts = [read_image(chans[c]) for c in sorted(chans)]
            img = parts[0]
            arr = np.stack([(p.array if not p.is_vector else p.array[..., 0])
                            for p in parts], axis=-1)
        if arr.ndim != 3:
            raise ValueError(f'case {stem}: expected 2D images, got '
                             f'array shape {arr.shape}')
        if arr.shape[-1] != n_ch:
            raise ValueError(f'case {stem}: {arr.shape[-1]} channels, '
                             f'dataset.json declares {n_ch}')
        image = MedicalImage(array=np.ascontiguousarray(arr, np.float32),
                             spacing=img.spacing[:2], origin=img.origin[:2],
                             is_vector=True)

        lbl_path = os.path.join(lbl_dir, stem + ending)
        if not os.path.exists(lbl_path):
            raise FileNotFoundError(f'case {stem}: missing label file '
                                    f'{lbl_path}')
        lbl = read_image(lbl_path)
        larr = lbl.array if lbl.is_vector else lbl.array[..., None]
        if multilabel and larr.shape[-1] == 1 and n_labels > 1:
            # labelmap -> one-hot channels (value v -> channel v-1)
            larr = np.stack([(larr[..., 0] == v) for v in
                             range(1, n_labels + 1)], axis=-1)
        seg = MedicalImage(array=np.ascontiguousarray(larr, np.uint8),
                           spacing=image.spacing, is_vector=True)
        if seg.array.shape[:2] != image.array.shape[:2]:
            raise ValueError(f'case {stem}: image {image.array.shape[:2]} '
                             f'vs label {seg.array.shape[:2]} shape mismatch')
        cases.append((image, seg))
    if not cases:
        raise ValueError(f'no cases found under {img_dir}')
    return cases, channel_names, labels, multilabel, ending


def _fold_split(n: int, fold: int, n_folds: int,
                val_fraction: float, seed: int) -> Tuple[List[int], List[int]]:
    """(train_indices, holdout_indices) for one fold: round-robin K-fold
    when n_folds > 1, else a seeded val_fraction tail."""
    idx = list(range(n))
    if n_folds > 1:
        hold = [i for i in idx if i % n_folds == fold]
        train = [i for i in idx if i % n_folds != fold] or idx
        return train, hold
    if val_fraction > 0:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        k = max(1, int(round(n * val_fraction)))
        if k >= n:  # never hold out everything
            k = n - 1
        return sorted(perm[k:].tolist()), sorted(perm[:k].tolist())
    return idx, []


def _one_hot(arr: np.ndarray, n_labels: int) -> np.ndarray:
    """(H, W, C) prediction/target -> boolean (H, W, n_labels): labelmaps
    (single channel holding integer values) one-hot; per-channel masks
    binarize."""
    if arr.shape[-1] < n_labels:  # labelmap -> one-hot
        return np.stack([(arr[..., 0] == v) for v in
                         range(1, n_labels + 1)], axis=-1)
    return arr[..., :n_labels].astype(bool)


def _validate(model, cases: Sequence[Tuple[MedicalImage, MedicalImage]],
              holdout: Sequence[int], n_labels: int,
              device=None) -> Optional[np.ndarray]:
    """Per-label Dice of the EXPORTED model on held-out cases, through the
    real inference path (zoo load -> HostedModel.apply on ``device``)."""
    if not holdout:
        return None
    model.start(device)
    inter = np.zeros(n_labels)
    denom = np.zeros(n_labels)
    for i in holdout:
        img, seg = cases[i]
        pred = model.apply(img)
        p = _one_hot(pred.array if pred.is_vector else pred.array[..., None],
                     n_labels)
        t = _one_hot(seg.array, n_labels)
        inter += 2 * np.logical_and(p, t).sum(axis=(0, 1))
        denom += p.sum(axis=(0, 1)) + t.sum(axis=(0, 1))
    return (inter + 1e-5) / (denom + 1e-5)


def ts2d_train(dataset: str, output: str, model: str = 'ts2d-custom',
               group: str = 'all', steps: int = 1000,
               batch_size: Optional[int] = None, lr: float = 1e-2,
               seed: int = 0, n_folds: int = 1, val_fraction: float = 0.0,
               augment: bool = False, bf16: bool = False, remat: bool = False,
               mesh_spec: Optional[str] = None, oversample: float = 0.33,
               max_patch: int = 512, modality: str = 'CT', revision: int = 1,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 0, resume: bool = False,
               log_every: int = 50, pack: Optional[str] = None,
               device=None) -> str:
    """Run the full plan -> train -> export pipeline on ``device`` (None =
    the CUDA card, 'cpu' when asked); returns the model id."""
    from ..inference import Zoo
    from ..models.export import export_model_dir
    from ..models.plans import parse_model_spec
    from .data import PatchSampler, preprocess_case
    from .planner import compute_fingerprint, plan_experiment
    from .train import TrainConfig, Trainer

    if mesh_spec:
        raise NotImplementedError(
            f'--mesh {mesh_spec!r} is not ported yet: training over a device '
            f'mesh comes with the parallel slice (torch.distributed)')
    device = resolve_device(device)
    # database keys are lowercase (FileDataBase.resource_path lowercases on
    # lookup while export writes verbatim): normalize up front so a
    # mixed-case --model never fails AFTER the training run
    if model != model.lower() or group != group.lower():
        log(f'normalizing model id to lowercase: '
            f'{model}_{group} -> {model.lower()}_{group.lower()}')
        model, group = model.lower(), group.lower()

    cases, channel_names, labels, multilabel, ending = \
        load_raw_dataset(dataset)
    log(f'dataset: {len(cases)} cases, {len(channel_names)} channel(s), '
        f'{len(labels)} label(s), '
        f'{"multilabel" if multilabel else "softmax"}')
    if augment and not multilabel:
        raise ValueError('--augment requires a multilabel dataset (the '
                         'spatial transforms interpolate one-hot channels; '
                         'integer labelmaps would corrupt)')

    fp = compute_fingerprint([c[0] for c in cases], [c[1] for c in cases])
    plans, ds_json = plan_experiment(
        fp, channel_names, labels, modality=modality,
        multilabel=multilabel, max_patch=max_patch)
    ds_json['file_ending'] = ending
    ds_json['numTraining'] = len(cases)
    spec = parse_model_spec(plans, ds_json)
    log(f'plan: patch={spec.preprocess.patch_size} '
        f'spacing={tuple(round(s, 3) for s in spec.preprocess.spacing)} '
        f'stages={spec.arch.n_stages} '
        f'features={spec.arch.features_per_stage}')

    # preprocess lazily: holdout-only cases never need their preprocessed
    # form (validation runs on the ORIGINAL images through the real
    # inference path), so with --val-fraction a slice of the dataset skips
    # the device normalization + cubic resample entirely
    _pre_cache: Dict[int, tuple] = {}

    def pre(i: int) -> tuple:
        if i not in _pre_cache:
            _pre_cache[i] = preprocess_case(*cases[i], spec, device=device)
        return _pre_cache[i]

    bsz = int(batch_size) if batch_size else \
        int(plans['configurations']['2d'].get('batch_size', 2))
    cfg = TrainConfig(lr=lr, total_steps=steps, multilabel=multilabel,
                      deep_supervision=True, augment=augment,
                      compute_dtype='bfloat16' if bf16 else None,
                      remat=remat)

    fold_params = []
    fold_dice = []
    for fold in range(n_folds):
        train_idx, hold_idx = _fold_split(len(cases), fold, n_folds,
                                          val_fraction, seed)
        sampler = PatchSampler([pre(i) for i in train_idx],
                               spec.preprocess.patch_size,
                               oversample_foreground=oversample,
                               seed=seed + fold)
        trainer = Trainer(spec.arch, cfg, seed=seed + fold, device=device)
        ckpt = (os.path.join(os.path.abspath(checkpoint_dir),
                             f'fold_{fold}.pth')
                if checkpoint_dir else None)
        start = 0
        if resume and ckpt and os.path.exists(ckpt):
            trainer.restore_checkpoint(ckpt)
            start = trainer.step_count
            log(f'fold {fold}: resumed at step {start}')
        for s in range(start, steps):
            # multilabel targets ship as packed bit-planes (8x fewer
            # host-to-device bytes; Trainer.step unpacks on the device)
            batch = sampler.sample_batch(bsz, pack_targets=multilabel)
            if not multilabel:
                batch['target'] = batch['target'][..., 0].astype(np.int32)
            loss = trainer.step(batch)
            if log_every and ((s + 1) % log_every == 0 or s + 1 == steps):
                log(f'fold {fold} step {s + 1}/{steps}: '
                    f'loss {float(loss):.4f}')
            if (ckpt and checkpoint_every
                    and (s + 1) % checkpoint_every == 0):
                trainer.save_checkpoint(ckpt)
        if ckpt and checkpoint_every:
            trainer.save_checkpoint(ckpt)
        fold_params.append({k: v.cpu() for k, v in trainer.params.items()})
        fold_dice.append((fold, hold_idx))
        trainer.close()

    mid = export_model_dir(output, model, group, spec, fold_params,
                           revision=revision, epoch=steps)
    log(f'exported {mid} (r{revision:03d}) to {output}')
    if pack:
        from ..inference import FileDataBase
        FileDataBase(output).pack_zip(mid, pack, revision=revision)
        log(f'packed {mid} into {pack} (registry-shape zip: serve it from '
            f'any URL and point shared.json at it)')

    # validation through the REAL inference path: the exported model, loaded
    # back through the zoo, predicting held-out original-resolution cases.
    # Each fold's holdout is scored by THAT FOLD's checkpoint alone
    # (param nnu.folds=[f]) — the all-folds ensemble contains folds trained
    # on these very cases, which would leak and inflate the CV metric.
    if any(hold for _, hold in fold_dice):
        zoo = Zoo(remote=False, local=output)
        n_labels = max(labels.values())
        names = {v: k for k, v in labels.items()}
        for fold, hold in fold_dice:
            if not hold:
                continue
            hosted = zoo.load(mid, param={'nnu': {'folds': [fold]}})
            dice = _validate(hosted, cases, hold, n_labels, device)
            per = ', '.join(f'{names.get(v + 1, v + 1)}={dice[v]:.3f}'
                            for v in range(n_labels))
            log(f'fold {fold} holdout Dice ({len(hold)} cases, '
                f'fold-{fold} weights only): '
                f'mean {float(dice.mean()):.3f} [{per}]')
    return mid


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog='ts2d-torch-train',
        description='Train a TS2D-style 2D segmentation model from an '
                    'nnU-Net-raw-layout dataset and export it to the model '
                    'zoo layout.')
    parser.add_argument('--dataset', '-d', required=True,
                        help='dataset dir (dataset.json + imagesTr/ + '
                             'labelsTr/)')
    parser.add_argument('--output', '-o', required=True,
                        help='model database root to export into (e.g. '
                             '~/.ts2d/models)')
    parser.add_argument('--model', default='ts2d-custom',
                        help='model name for the exported id '
                             '(default: ts2d-custom)')
    parser.add_argument('--group', default='all',
                        help='anatomical group suffix of the exported id '
                             '(default: all)')
    parser.add_argument('--steps', type=int, default=1000)
    parser.add_argument('--batch-size', type=int, default=None,
                        help='default: the planned batch size')
    parser.add_argument('--lr', type=float, default=1e-2)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--folds', type=int, default=1,
                        help='K-fold cross-validation: trains K models into '
                             'fold_0..K-1 (default 1)')
    parser.add_argument('--val-fraction', type=float, default=0.0,
                        help='with --folds 1: fraction of cases held out '
                             'for validation Dice')
    parser.add_argument('--augment', action='store_true',
                        help='apply the on-device nnU-Net augmentation '
                             'recipe to every batch')
    parser.add_argument('--bf16', action='store_true',
                        help='bfloat16 compute (fp32 params/loss)')
    parser.add_argument('--remat', action='store_true',
                        help='rematerialize the forward in the backward '
                             'pass (larger patches/batches per HBM)')
    parser.add_argument('--mesh', default=None,
                        help='shard the step over a device mesh (comes with '
                             'the parallel slice; refused here)')
    parser.add_argument('--oversample', type=float, default=0.33,
                        help='foreground patch oversampling fraction')
    parser.add_argument('--max-patch', type=int, default=512)
    parser.add_argument('--modality', default='CT',
                        help='CT enables nnU-Net CTNormalization (clip to '
                             'fingerprint percentiles); anything else '
                             'z-scores')
    parser.add_argument('--revision', type=int, default=1)
    parser.add_argument('--checkpoint-dir', default=None)
    parser.add_argument('--checkpoint-every', type=int, default=0,
                        help='save the training state (torch.save) every '
                             'N steps')
    parser.add_argument('--resume', action='store_true',
                        help='resume from --checkpoint-dir if present')
    parser.add_argument('--log-every', type=int, default=50)
    parser.add_argument('--pack', default=None, metavar='ZIP',
                        help='also package the exported model into a '
                             'registry-shape zip (shareable like the '
                             'published Zenodo models)')
    parser.add_argument('--device', default=None,
                        help="'cuda' (default: the CUDA card) or 'cpu'")
    parser.add_argument('--silent', action='store_true')
    args = parser.parse_args(argv)

    if args.silent:
        log_silent(True)
    mid = ts2d_train(
        dataset=args.dataset, output=args.output, model=args.model,
        group=args.group, steps=args.steps, batch_size=args.batch_size,
        lr=args.lr, seed=args.seed, n_folds=args.folds,
        val_fraction=args.val_fraction, augment=args.augment, bf16=args.bf16,
        remat=args.remat, mesh_spec=args.mesh, oversample=args.oversample,
        max_patch=args.max_patch, modality=args.modality,
        revision=args.revision, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        log_every=args.log_every, pack=args.pack, device=args.device)
    print(mid)


if __name__ == '__main__':
    main()
