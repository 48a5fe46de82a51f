"""``ts2d-torch-train`` (training/cli.py), export (models/export.py) and
eval (eval.py) of the port, on the CPU, against the reference package's.

A raw nnU-Net dataset is written to disk (NRRD through the port's codec,
and PNG through the port's encoder), the whole plan -> preprocess -> train
-> export -> validate pipeline runs through the console surface, and the
exported model is loaded back through both packages' zoos: the reference's
``HostedModel.apply`` agrees with the port's at >= 0.999 of the mask
pixels (the U-Net bar of the full chain). A model the reference exports
loads in the port at the same bar. Eval equals the reference's."""

import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from totalsegmentator2d_tpu.eval import dice_per_label as jax_dice
from totalsegmentator2d_tpu.inference import Zoo as JaxZoo
from totalsegmentator2d_tpu.io import MedicalImage as JaxImage
from totalsegmentator2d_tpu.models.export import export_model_dir as jax_export
from totalsegmentator2d_tpu.models.plans import ArchSpec as JaxArch
from totalsegmentator2d_tpu.models.plans import ModelSpec as JaxSpec
from totalsegmentator2d_tpu.models.plans import PreprocessSpec as JaxPre
from totalsegmentator2d_tpu.models.unet import init_params_np as jax_init_np
from totalsegmentator2d_tpu.ops.annotations import set_annotation_meta as jax_meta
from totalsegmentator2d_tpu.training import load_raw_dataset as jax_load_raw

from totalsegmentator2d_tpu_torch.eval import dice_per_label, evaluate
from totalsegmentator2d_tpu_torch.inference import Zoo
from totalsegmentator2d_tpu_torch.inference.database import extract_zip
from totalsegmentator2d_tpu_torch.io import MedicalImage, encode_png, write_image
from totalsegmentator2d_tpu_torch.models.export import export_model_dir
from totalsegmentator2d_tpu_torch.models.plans import (ArchSpec, ModelSpec,
                                                       PreprocessSpec)
from totalsegmentator2d_tpu_torch.ops.annotations import set_annotation_meta
from totalsegmentator2d_tpu_torch.training import (PatchSampler, TrainConfig,
                                                   Trainer,
                                                   compute_fingerprint,
                                                   load_raw_dataset,
                                                   plan_experiment,
                                                   preprocess_case, ts2d_train)
from totalsegmentator2d_tpu_torch.training.cli import _one_hot, main
from totalsegmentator2d_tpu_torch.utils.files import write_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_dataset(root, n_cases=4, per_channel=False, labelmap=False,
                  multilabel=True, png=False):
    """dataset.json + imagesTr/ + labelsTr/ with 2-channel 72x64 cases:
    NRRD vector images, or one 8-bit PNG per channel with PNG label maps."""
    rng = np.random.default_rng(5)
    img_dir = os.path.join(root, 'imagesTr')
    lbl_dir = os.path.join(root, 'labelsTr')
    os.makedirs(img_dir)
    os.makedirs(lbl_dir)
    ending = '.png' if png else '.nrrd'
    write_json(os.path.join(root, 'dataset.json'), {
        'channel_names': {'0': 'max', '1': 'mean'},
        'labels': {'background': 0, 'heart': 1, 'aorta': 2},
        'numTraining': n_cases, 'file_ending': ending,
        'multilabel': multilabel})
    for i in range(n_cases):
        h, w = 72, 64
        arr = (rng.standard_normal((h, w, 2)) * 150 + 30).astype(np.float32)
        tgt = np.zeros((h, w, 2), np.uint8)
        tgt[10 + i:30 + i, 8:28, 0] = 1
        tgt[40:60, 30 + i:50 + i, 1] = 1
        arr[..., 0] += 300.0 * tgt[..., 0]
        arr[..., 1] += 300.0 * tgt[..., 1]
        lm = (tgt[..., 0] * 1 + tgt[..., 1] * 2).astype(np.uint8)
        if png:
            for c in range(2):
                u8 = np.clip(arr[..., c] / 4 + 64, 0, 255).astype(np.uint8)
                with open(os.path.join(img_dir, f'case{i:02d}_{c:04d}.png'),
                          'wb') as f:
                    f.write(encode_png(u8))
            with open(os.path.join(lbl_dir, f'case{i:02d}.png'), 'wb') as f:
                f.write(encode_png(lm))
            continue
        if per_channel:
            for c in range(2):
                write_image(MedicalImage(array=arr[..., c], spacing=(1.0, 1.0)),
                            os.path.join(img_dir, f'case{i:02d}_{c:04d}.nrrd'))
        else:
            write_image(MedicalImage(array=arr, spacing=(1.0, 1.0),
                                     is_vector=True),
                        os.path.join(img_dir, f'case{i:02d}.nrrd'))
        if labelmap:
            write_image(MedicalImage(array=lm, spacing=(1.0, 1.0)),
                        os.path.join(lbl_dir, f'case{i:02d}.nrrd'))
        else:
            write_image(MedicalImage(array=tgt, spacing=(1.0, 1.0),
                                     is_vector=True),
                        os.path.join(lbl_dir, f'case{i:02d}.nrrd'))


# -- the raw dataset -------------------------------------------------------------

@pytest.mark.parametrize('layout', ['vector', 'per_channel', 'labelmap', 'png'])
def test_load_raw_dataset_matches_reference(tmp_path, layout):
    _make_dataset(str(tmp_path), per_channel=layout == 'per_channel',
                  labelmap=layout == 'labelmap', png=layout == 'png')
    ours = load_raw_dataset(str(tmp_path))
    ref = jax_load_raw(str(tmp_path))
    assert ours[1:] == ref[1:]
    assert len(ours[0]) == len(ref[0]) == 4
    for (a, b), (c, d) in zip(ours[0], ref[0]):
        for x, y in ((a, c), (b, d)):
            assert x.array.dtype == y.array.dtype
            np.testing.assert_array_equal(x.array, y.array)
            assert x.spacing == y.spacing and x.is_vector == y.is_vector
    seg = ours[0][0][1].array
    assert seg.shape == (72, 64, 2) and set(np.unique(seg)) <= {0, 1}


def test_load_raw_dataset_errors(tmp_path):
    a, b = tmp_path / 'a', tmp_path / 'b'
    _make_dataset(str(a))
    os.remove(a / 'labelsTr' / 'case01.nrrd')
    with pytest.raises(FileNotFoundError, match='case01'):
        load_raw_dataset(str(a))
    _make_dataset(str(b), per_channel=True)
    os.remove(b / 'imagesTr' / 'case02_0001.nrrd')
    with pytest.raises(ValueError, match='case02'):
        load_raw_dataset(str(b))


def test_one_hot_labelmap_vs_channels():
    lm = np.zeros((4, 4, 1), np.uint8)
    lm[0, 0, 0] = 1
    lm[1, 1, 0] = 2
    oh = _one_hot(lm, 2)
    assert oh.shape == (4, 4, 2)
    assert oh[0, 0, 0] and not oh[0, 0, 1] and oh[1, 1, 1] and not oh[1, 1, 0]
    ch = np.zeros((4, 4, 2), np.uint8)
    ch[2, 2, 1] = 1
    out = _one_hot(ch, 2)
    assert out[2, 2, 1] and out.sum() == 1


# -- the CLI end to end ----------------------------------------------------------

def _agreement(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def test_cli_png_dataset_end_to_end(tmp_path, capsys):
    """PNG channels and label maps, 2 folds, --augment, --pack: a zoo model
    that both packages load and agree on, per-fold holdout Dice."""
    data = tmp_path / 'Dataset501_toy'
    data.mkdir()
    _make_dataset(str(data), png=True)
    out = tmp_path / 'models'
    pack = tmp_path / 'share' / 'toy.zip'
    main(['-d', str(data), '-o', str(out), '--model', 'ts2d-toy',
          '--group', 'cardiac', '--steps', '4', '--batch-size', '2',
          '--max-patch', '64', '--folds', '2', '--log-every', '2',
          '--seed', '1', '--augment', '--pack', str(pack), '--device', 'cpu'])
    text = capsys.readouterr().out
    assert 'loss' in text and 'fold-0 weights only' in text \
        and 'fold-1 weights only' in text
    assert text.strip().splitlines()[-1] == 'ts2d-toy_cardiac'
    mid = 'ts2d-toy_cardiac'
    results = list((out / mid / 'r001').glob(
        'Dataset*/nnUNetTrainer__nnUNetPlans__2d'))
    for f in ('plans.json', 'dataset.json', 'fold_0/checkpoint_final.pth',
              'fold_1/checkpoint_final.pth'):
        assert (results[0] / f).exists(), f
    # the packed zip reproduces the entry in another database
    other = tmp_path / 'other'
    extract_zip(str(pack), str(other))
    assert (other / mid / 'r001' / 'model.json').exists()
    with zipfile.ZipFile(pack) as zf:
        assert all(n.startswith(mid + '/r001/') for n in zf.namelist())

    ours = Zoo(remote=False, local=str(other)).load(mid)
    ours.start('cpu')
    ref = JaxZoo(remote=False, local=str(out)).load(mid)
    case = load_raw_dataset(str(data))[0][0][0]
    a = ours.apply(case)
    b = ref.apply(JaxImage(array=case.array, spacing=case.spacing,
                           is_vector=True))
    assert a.array.shape == b.array.shape == (72, 64, 2)
    assert _agreement(a.array, b.array) >= 0.999


def test_cli_nrrd_val_fraction_and_refusals(tmp_path, capsys):
    data = tmp_path / 'ds'
    data.mkdir()
    _make_dataset(str(data))
    out = tmp_path / 'models'
    mid = ts2d_train(str(data), str(out), model='TS2D-Case', group='Organs',
                     steps=2, batch_size=2, max_patch=64, log_every=0,
                     val_fraction=0.25, device='cpu')
    assert mid == 'ts2d-case_organs'
    assert (out / mid / 'r001' / 'model.json').exists()
    assert 'holdout Dice' in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match='parallel slice'):
        main(['-d', str(data), '-o', str(out), '--mesh', 'data=4',
              '--device', 'cpu'])
    soft = tmp_path / 'soft'
    soft.mkdir()
    _make_dataset(str(soft), labelmap=True, multilabel=False)
    with pytest.raises(ValueError, match='augment'):
        ts2d_train(str(soft), str(tmp_path / 'out'), steps=1, augment=True,
                   device='cpu')


def test_cli_checkpoint_and_resume(tmp_path, capsys):
    """--checkpoint-dir writes a torch.save file per fold; --resume picks
    the run up at its step."""
    data = tmp_path / 'ds'
    data.mkdir()
    _make_dataset(str(data), n_cases=2)
    common = ['-d', str(data), '-o', str(tmp_path / 'models'),
              '--batch-size', '2', '--max-patch', '64', '--log-every', '1',
              '--checkpoint-dir', str(tmp_path / 'ckpt'),
              '--checkpoint-every', '1', '--device', 'cpu']
    main(common + ['--steps', '2'])
    assert (tmp_path / 'ckpt' / 'fold_0.pth').exists()
    capsys.readouterr()
    main(common + ['--steps', '3', '--resume'])
    text = capsys.readouterr().out
    assert 'fold 0: resumed at step 2' in text
    assert 'step 3/3' in text and 'step 1/3' not in text


def test_plan_train_export_predict(tmp_path):
    """The full circle in the library: fingerprint -> plans -> trainer ->
    export -> zoo -> predict, the loss falling on a fixed batch."""
    rng = np.random.default_rng(0)
    cases = []
    for _ in range(2):
        arr = (rng.standard_normal((96, 96, 2)) * 200 + 50).astype(np.float32)
        tgt = np.zeros((96, 96, 2), np.uint8)
        tgt[24:48, 24:48, 0] = 1
        tgt[48:86, 48:86, 1] = 1
        cases.append((MedicalImage(array=arr, spacing=(1.5, 1.5),
                                   is_vector=True),
                      MedicalImage(array=tgt, spacing=(1.5, 1.5),
                                   is_vector=True)))
    fp = compute_fingerprint([c[0] for c in cases], [c[1] for c in cases])
    plans, ds = plan_experiment(fp, {0: 'max', 1: 'mean'},
                                {'heart': 1, 'aorta': 2}, max_patch=64)
    from totalsegmentator2d_tpu_torch.models.plans import parse_model_spec
    spec = parse_model_spec(plans, ds)
    pre = [preprocess_case(img, seg, spec, device='cpu') for img, seg in cases]
    fixed = PatchSampler(pre, spec.preprocess.patch_size, seed=0).sample_batch(2)
    tr = Trainer(spec.arch, TrainConfig(lr=1e-2, total_steps=8), seed=0,
                 device='cpu')
    losses = [float(tr.step(fixed)) for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    mid = export_model_dir(str(tmp_path), 'ts2d-v9-loop', 'cardiac', spec,
                           [tr.model], epoch=8)
    model = Zoo(remote=False, local=str(tmp_path)).load(mid)
    model.start('cpu')
    seg = model.apply(cases[0][0])
    assert seg.ncomponents == 2 and seg.size == cases[0][0].size


# -- export across the packages ---------------------------------------------------

def _specs():
    kw = dict(n_stages=3, features_per_stage=(8, 16, 16),
              kernel_sizes=((3, 3),) * 3, strides=((1, 1), (2, 2), (2, 2)),
              n_conv_per_stage=(2, 2, 2), n_conv_per_stage_decoder=(2, 2),
              in_channels=2, out_channels=2)
    pre = dict(spacing=(1.5, 1.5), patch_size=(32, 32),
               normalization_schemes=('ZScoreNormalization',) * 2,
               use_mask_for_norm=(False, False),
               intensity_properties=(None, None))
    rest = dict(labels={1: 'heart', 2: 'aorta'},
                channel_names={0: 'max', 1: 'mean'}, multilabel=True,
                allowed_mirroring_axes=(1,))
    return (JaxSpec(arch=JaxArch(**kw), preprocess=JaxPre(**pre), **rest),
            ModelSpec(arch=ArchSpec(**kw), preprocess=PreprocessSpec(**pre),
                      **rest))


def _image(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((40, 30, 2)) + 2).astype(np.float32)


@pytest.mark.parametrize('exporter', ['port', 'reference'])
def test_export_loads_in_both_zoos(tmp_path, exporter):
    jspec, pspec = _specs()
    folds = [jax_init_np(s, jspec.arch) for s in (0, 1)]
    if exporter == 'port':
        from totalsegmentator2d_tpu_torch.models.convert import params_from_jax
        mid = export_model_dir(str(tmp_path), 'ts2d-v9-exp', 'cardiac', pspec,
                               [params_from_jax(p) for p in folds], epoch=40)
    else:
        mid = jax_export(str(tmp_path), 'ts2d-v9-exp', 'cardiac', jspec,
                         folds, epoch=40)
    ours = Zoo(remote=False, local=str(tmp_path)).load(mid)
    ref = JaxZoo(remote=False, local=str(tmp_path)).load(mid)
    assert ours.folds == ref.folds == [0, 1]
    assert ours.labels == ref.labels and ours.channels == ref.channels
    w = ours.load_fold_params()[1]['encoder.stages.0.convs.0.conv.weight']
    ref.load_fold_params()   # the checkpoints' meta sets the mirror axes
    assert ours.spec.allowed_mirroring_axes == \
        ref.spec.allowed_mirroring_axes == (1,)
    np.testing.assert_array_equal(
        w.numpy(), np.transpose(folds[1]['encoder']['stages'][0][0]['conv']['w'],
                                (3, 2, 0, 1)))
    ours.start('cpu')
    arr = _image(3)
    a = ours.apply(MedicalImage(array=arr, spacing=(1.5, 1.5), is_vector=True))
    b = ref.apply(JaxImage(array=arr, spacing=(1.5, 1.5), is_vector=True))
    assert a.meta['Segment0_Name'] == 'heart'
    assert _agreement(a.array, b.array) >= 0.999


# -- eval -------------------------------------------------------------------------

def _seg(mask_a, mask_b, port=True, names=('heart', 'aorta')):
    arr = np.stack([mask_a, mask_b], axis=-1).astype(np.uint8)
    img = (MedicalImage if port else JaxImage)(array=arr, spacing=(1.0, 1.0),
                                               is_vector=True)
    (set_annotation_meta if port else jax_meta)(
        img, names={1: names[0], 2: names[1]},
        colors={n: '#ff0000' for n in names})
    return img


@pytest.mark.parametrize('case', ['exact_partial', 'missing', 'labelmap'])
def test_dice_matches_reference(case):
    a = np.zeros((10, 10), bool)
    a[2:6, 2:6] = True
    b = np.zeros((10, 10), bool)
    b[2:6, 2:8] = True
    if case == 'exact_partial':
        pairs = ((a, a), (a, b))
    elif case == 'missing':
        pairs = ((a, np.zeros_like(a)), (a, a))
    if case == 'labelmap':
        lm_p = (a * 1 + (b & ~a) * 3).astype(np.uint8)
        lm_g = (b * 1).astype(np.uint8)
        ours = dice_per_label(MedicalImage(array=lm_p), MedicalImage(array=lm_g),
                              device='cpu')
        ref = jax_dice(JaxImage(array=lm_p), JaxImage(array=lm_g))
    else:
        ours = dice_per_label(_seg(*pairs[0]), _seg(*pairs[1]), device='cpu')
        ref = jax_dice(_seg(*pairs[0], port=False), _seg(*pairs[1], port=False))
    assert ours == ref
    if case == 'exact_partial':
        assert ours['heart'] == 1.0
        assert abs(ours['aorta'] - 2 * 16 / (16 + 24)) < 1e-6


def test_evaluate_files_and_cli(tmp_path):
    a = np.zeros((8, 8), bool)
    a[1:5, 1:5] = True
    p1, p2 = str(tmp_path / 'pred.nrrd'), str(tmp_path / 'gt.nrrd')
    write_image(_seg(a, a), p1)
    write_image(_seg(a, np.zeros_like(a)), p2)
    res = evaluate(p1, p2, device='cpu')
    assert res['n_labels'] == 2 and res['mean_dice'] == 0.5
    proc = subprocess.run(
        [sys.executable, '-m', 'totalsegmentator2d_tpu_torch.eval', p1, p1,
         '--device', 'cpu'], capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout)['mean_dice'] == 1.0


def test_train_console_script_declared():
    text = open(os.path.join(REPO, 'pyproject.toml')).read()
    assert ('ts2d-torch-train = "totalsegmentator2d_tpu_torch.training.cli:main"'
            in text)
