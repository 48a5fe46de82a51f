"""Parity harness of the PyTorch port (the port's counterpart of
tools/parity.py): the port's engines against an independent oracle of the
reference's nnU-Net predict chain, and against goldens.

The oracle is ``tests/reference_chain.predict``: crop_to_nonzero,
normalization, scipy's order-3 resize, nnU-Net's sliding window with
per-tile mirror TTA, the Gaussian overlap-add and the order-1 resize of the
logits, in numpy, scipy and torch. Its nets are the port's ``UNet`` run on
the CPU in fp32, so the oracle shares the U-Net with the engines under test
and nothing else (tests/reference_chain.py's ``build_config`` reaches the
reference package, so this tool builds its configurations itself);
``tests/test_torch_models.py`` holds that U-Net against the independent
``tests/torch_mirror.py`` separately. The tool imports torch, numpy and
scipy, never jax or the reference package.

Modes
-----
offline (the default)
    ``python tools/torch_parity.py [--checks a,b] [--configs x,y]
    [--out report.json]``: on the CPU, the semantic checks of
    tools/parity.py on the port's engines: gaussian-window,
    crop-roundtrip, volume-crop, resample-order, fused-vs-permodel,
    full-chain (the 6 configurations, a multi-tile grid, no mirroring and
    the four bundled assets: logit error < 5e-3, 1e-2 on the assets, and
    mask agreement >= 0.999), full-chain-batched and full-chain-quantized
    (borderline-only flips within a 2e-2 margin, agreement >= 0.999) and
    full-chain-bench-arch (the 6-stage, 256^2, 26-label architecture:
    logit error < 2e-2). ``--configs`` keeps only those configurations,
    ``--assets`` only those bundled assets.
device
    ``python tools/torch_parity.py --device cuda``: the 6 configurations'
    whole chain on the card against the oracle on the CPU, at logit error
    < 2e-2 and borderline-only flips (every pixel that disagrees sits
    within 3x the measured logit drift of the decision threshold).
real
    ``python tools/torch_parity.py --models <root> [--key ts2d]
    [--golden <dir>] [--outdir <dir>] [--device cpu|cuda]``: a local model
    database predicts the bundled assets, writes the segmentations, and
    reports per-label Dice and voxel agreement against
    ``<golden>/<asset>.seg.nrrd`` where they exist.

The report goes to ``--out``, or to stdout; the last line printed is
``{"ok": ..., "report": ...}`` and the exit code is 0 when every check held.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

ASSETS = ('sample_s0521', 'sample_s0332', 'sample_s0616', 'sample_chexpert')
CONFIGS = ('multilabel', 'softmax', 'masked-norm', 'resampling',
           'multifold', 'ct-norm')
#: the CPU bars of tests/test_019_full_chain_parity.py
LOGIT_BAR = 5e-3
AGREE_BAR = 0.999
#: logit bar of a chain on the card (tools/parity.py's device check)
DEVICE_BAR = 2e-2
#: borderline margin of the batched and quantized programs (tools/parity.py)
LOAD_MARGIN = 2e-2


# -- configurations ------------------------------------------------------------

def make_plans(patch=(64, 64), spacing=(1.5, 1.5), channels=('max', 'mean'),
               n_stages=4, features=(8, 16, 32, 32)):
    """An nnU-Net plans dict of the synthetic model family (the layout of
    tests/model_fixtures.py)."""
    n_ch = len(channels)
    return {'configurations': {'2d': {
        'patch_size': list(patch), 'spacing': list(spacing),
        'normalization_schemes': ['ZScoreNormalization'] * n_ch,
        'use_mask_for_norm': [False] * n_ch,
        'architecture': {'arch_kwargs': {
            'n_stages': n_stages,
            'features_per_stage': list(features[:n_stages]),
            'kernel_sizes': [[3, 3]] * n_stages,
            'strides': [[1, 1]] + [[2, 2]] * (n_stages - 1),
            'n_conv_per_stage': [2] * n_stages,
            'n_conv_per_stage_decoder': [2] * (n_stages - 1),
            'conv_bias': True,
            'norm_op_kwargs': {'eps': 1e-05, 'affine': True},
            'nonlin_kwargs': {'inplace': True}}}}},
        'foreground_intensity_properties_per_channel': {}}


def make_dataset_json(labels, channels=('max', 'mean'), multilabel=True):
    return {'channel_names': {str(i): c for i, c in enumerate(channels)},
            'labels': {'background': 0,
                       **{n: i + 1 for i, n in enumerate(labels)}},
            'file_ending': '.nrrd', 'multilabel': multilabel}


class OracleNet:
    """A port ``UNet`` as the oracle calls it: (N, C, H, W) in, fp32
    logits (N, L, H, W) out, on the CPU."""

    def __init__(self, net):
        self.net = net

    def __call__(self, x):
        return self.net.forward_nchw(x)


def build_config(name, channels=('max', 'mean')):
    """(spec, oracle nets, fold state dicts) of a named configuration: the
    matrix of tests/reference_chain.build_config, with the port's spec and
    random port ``UNet`` weights seeded per fold."""
    import torch

    from totalsegmentator2d_tpu_torch.models.plans import parse_model_spec
    from totalsegmentator2d_tpu_torch.models.unet import UNet

    labels, multilabel, n_folds = ('heart', 'aorta'), True, 1
    patch, n_stages, features = (64, 64), 4, (8, 16, 32, 32)
    if name == 'bench-arch':
        labels = tuple(f'vert-{i}' for i in range(26))
        patch, n_stages = (256, 256), 6
        features = (32, 64, 128, 256, 512, 512)
    plans = make_plans(patch=patch, channels=channels, n_stages=n_stages,
                       features=features)
    cfg2d = plans['configurations']['2d']
    if name == 'softmax':
        multilabel = False
    elif name == 'masked-norm':
        cfg2d['use_mask_for_norm'] = [True] * len(channels)
    elif name == 'ct-norm':
        cfg2d['normalization_schemes'] = (
            ['CTNormalization'] + ['ZScoreNormalization'] * (len(channels) - 1))
        plans['foreground_intensity_properties_per_channel'] = {
            '0': {'mean': 80.0, 'std': 140.0,
                  'percentile_00_5': -120.0, 'percentile_99_5': 400.0}}
    elif name == 'multifold':
        n_folds = 2
    elif name not in ('multilabel', 'resampling', 'bench-arch'):
        raise ValueError(f'unknown config {name}')
    spec = parse_model_spec(plans, make_dataset_json(labels, channels,
                                                     multilabel))
    nets, sds = [], []
    for f in range(n_folds):
        torch.manual_seed(100 + f)
        net = UNet(spec.arch).eval()
        nets.append(OracleNet(net))
        sds.append({k: v.detach().clone() for k, v in net.state_dict().items()})
    return spec, nets, sds


def _tests_module(name):
    """A module of the repository's tests/ loaded from its file (tests/
    is no package, and a package of that name elsewhere on the path would
    shadow it)."""
    import importlib.util
    key = f'_ts2d_tests_{name}'
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(REPO, 'tests', f'{name}.py'))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def _oracle():
    return _tests_module('reference_chain')


def oracle_predict(arr, spacing, spec, nets, **kw):
    """The oracle's (full-size seg, cropped logits, bbox), nets on the CPU
    in fp32 under torch.inference_mode."""
    import torch
    with torch.inference_mode():
        return _oracle().predict(arr, spacing, spec, nets, **kw)


# -- comparisons -----------------------------------------------------------------

def mask_vs_oracle(seg, ref_seg, ref_logits, bbox, spec, margin) -> dict:
    """An engine's full-size result against the oracle's: the agreement,
    and whether every flip is borderline: each disagreeing pixel's oracle
    decision sits within ``margin`` of the threshold (|logit| for sigmoid,
    the top-2 gap within 2 x margin for argmax); a disagreement outside the
    crop is never borderline. ``seg`` may be an (H, W) labelmap or the
    ensemble's one-hot channels (softmax: background dropped)."""
    seg, ref = np.asarray(seg), np.asarray(ref_seg)
    if not spec.multilabel and seg.ndim == ref.ndim + 1:
        ref = np.stack([ref == v + 1 for v in range(seg.shape[-1])],
                       axis=-1).astype(np.uint8)
    dis = seg != ref
    (y0, y1), (x0, x1) = bbox
    outside = dis.copy()
    outside[y0:y1, x0:x1] = False
    dis = dis[y0:y1, x0:x1]
    if spec.multilabel:
        flips = bool(np.all(np.abs(ref_logits[dis]) <= margin))
    else:
        part = np.partition(ref_logits, ref_logits.shape[-1] - 2, axis=-1)
        top2 = part[..., -1] - part[..., -2]
        if dis.ndim > top2.ndim:
            dis = np.any(dis, axis=-1)
        flips = bool(np.all(top2[dis] <= 2.0 * margin))
    return {'mask_agreement': float((seg == ref).mean()),
            'flips_borderline_only': flips and not outside.any()}


def logits_vs_oracle(seg, logits, bbox, ref) -> dict:
    ref_seg, ref_logits, ref_bbox = ref
    return {'max_abs_logit_err': float(np.abs(logits - ref_logits).max()),
            'mask_agreement': float((np.asarray(seg) == ref_seg).mean()),
            'bbox_match': tuple(bbox) == tuple(ref_bbox)}


def device_entry(seg, logits, bbox, ref, spec, bar=DEVICE_BAR) -> dict:
    """A chain's result on the card against the oracle: the logit drift
    under ``bar``, the bbox, and borderline-only flips within 3x the
    measured drift (at least 1e-4)."""
    entry = logits_vs_oracle(seg, logits, bbox, ref)
    drift = entry['max_abs_logit_err']
    entry['flips_borderline_only'] = mask_vs_oracle(
        seg, ref[0], ref[1], bbox, spec,
        3.0 * max(drift, 1e-4))['flips_borderline_only']
    entry['ok'] = bool(entry['bbox_match'] and drift < bar
                       and entry['flips_borderline_only'])
    return entry


# -- offline checks ---------------------------------------------------------------

def check_gaussian_window() -> dict:
    """The port's importance map against nnU-Net's construction."""
    from totalsegmentator2d_tpu_torch.ops.gaussian import gaussian_map
    patch = (256, 256)
    err = float(np.abs(np.asarray(gaussian_map(patch))
                       - _oracle().gaussian_importance(patch)).max())
    return {'ok': err < 1e-5, 'max_abs_err': err}


def _small_engine():
    from totalsegmentator2d_tpu_torch.inference import InferenceEngine
    from totalsegmentator2d_tpu_torch.models.convert import params_from_jax
    from totalsegmentator2d_tpu_torch.models.plans import parse_model_spec
    from totalsegmentator2d_tpu_torch.models.unet import init_params_np
    spec = parse_model_spec(make_plans(), make_dataset_json(('heart', 'aorta')))
    return InferenceEngine(spec, [params_from_jax(init_params_np(0, spec.arch))],
                           device='cpu')


def check_crop_roundtrip() -> dict:
    """Sparse input: predict_array == crop, predict, re-embed (nnU-Net
    crop_to_nonzero)."""
    eng = _small_engine()
    rng = np.random.default_rng(0)
    arr = np.zeros((120, 100, 2), np.float32)
    arr[20:90, 15:80] = rng.standard_normal((70, 65, 2)) + 2
    full = eng.predict_array(arr, (1.5, 1.5))
    inner = eng.predict_array(arr[20:90, 15:80], (1.5, 1.5))
    embedded = np.zeros_like(full)
    embedded[20:90, 15:80] = inner
    agree = float((full == embedded).mean())
    outside_clean = not full[:20].any() and not full[:, :15].any()
    return {'ok': agree > 0.9999 and outside_clean, 'agreement': agree,
            'outside_clean': bool(outside_clean)}


def check_volume_crop() -> dict:
    """Zero-background volume: the volume program == the 2D program on
    the host projection."""
    from totalsegmentator2d_tpu_torch.inference import EnsembleEngine
    from totalsegmentator2d_tpu_torch.models.convert import params_from_jax
    from totalsegmentator2d_tpu_torch.models.plans import parse_model_spec
    from totalsegmentator2d_tpu_torch.models.unet import init_params_np
    from totalsegmentator2d_tpu_torch.ops.projection import project_array_np

    specs, params = [], []
    for i, labels in enumerate((('heart', 'aorta'), ('r1', 'r2', 'r3'))):
        spec = parse_model_spec(make_plans(), make_dataset_json(labels))
        specs.append(spec)
        params.append([params_from_jax(init_params_np(i, spec.arch))])
    ens = EnsembleEngine(specs, params, device='cpu')
    rng = np.random.default_rng(1)
    vol = np.zeros((60, 30, 50), np.float32)
    vol[10:50, 5:25, 8:40] = rng.standard_normal((40, 20, 32)) * 100 + 50
    seg_vol, _ = ens.predict_volume(vol, (1.5, 1.5), ('max', 'mean'))
    proj = np.concatenate([project_array_np(vol, 'max', 1),
                           project_array_np(vol, 'mean', 1)],
                          axis=1).transpose(0, 2, 1)
    seg_2d = ens.predict_array(np.ascontiguousarray(proj, np.float32),
                               (1.5, 1.5))
    agree = float((seg_vol == seg_2d).mean())
    return {'ok': agree > 0.9999, 'agreement': agree}


def check_resample_order() -> dict:
    """nnU-Net thresholds after resampling the logits to the input grid."""
    eng = _small_engine()
    rng = np.random.default_rng(2)
    arr = (rng.standard_normal((80, 70, 2)) + 2).astype(np.float32)
    seg, logits, bbox = eng.predict_array(arr, (3.0, 3.0), return_logits=True)
    expect = (1.0 / (1.0 + np.exp(-logits.astype(np.float64))) > 0.5)
    (y0, y1), (x0, x1) = bbox
    agree = float((seg[y0:y1, x0:x1] == expect.astype(np.uint8)).mean())
    full_res = logits.shape[:2] == (y1 - y0, x1 - x0)
    return {'ok': agree == 1.0 and full_res, 'agreement': agree,
            'logits_at_input_grid': bool(full_res)}


def write_group_set(root, model, groups, seed=0):
    """A synthetic nnU-Net model database of the 4-stage family, written
    with the port's ``UNet``: one model per group, 1 fold."""
    import torch

    from totalsegmentator2d_tpu_torch.models.plans import parse_model_spec
    from totalsegmentator2d_tpu_torch.models.unet import UNet

    for i, (group, labels) in enumerate(groups.items()):
        plans, ds = make_plans(), make_dataset_json(labels)
        base = os.path.join(root, f'{model}_{group}', 'r001')
        data = os.path.join(base, f'Dataset{101 + i}_synth{group}',
                            'nnUNetTrainer__nnUNetPlans__2d')
        os.makedirs(os.path.join(data, 'fold_0'), exist_ok=True)
        with open(os.path.join(base, 'model.json'), 'w') as f:
            json.dump({'param': {'nnu': {'configuration': '2d',
                                         'folds': [0]}}}, f)
        for fn, obj in (('plans.json', plans), ('dataset.json', ds)):
            with open(os.path.join(data, fn), 'w') as f:
                json.dump(obj, f)
        torch.manual_seed(seed + i)
        net = UNet(parse_model_spec(plans, ds).arch)
        torch.save({'network_weights': net.state_dict(),
                    'inference_allowed_mirroring_axes': [0, 1],
                    'trainer_name': 'nnUNetTrainer'},
                   os.path.join(data, 'fold_0', 'checkpoint_final.pth'))


GROUPS = {'cardiac': ('heart', 'aorta'),
          'ribs': ('rib-left-1', 'rib-right-1', 'rib-left-2')}


def _asset_path(name):
    return _tests_module('synth_assets').asset_path(f'{name}.nrrd')


def check_fused_vs_permodel(assets=('sample_s0332', 'sample_s0616')) -> dict:
    """The fused ensemble == the per-model engines, on bundled assets."""
    from totalsegmentator2d_tpu_torch.api import TS2D
    from totalsegmentator2d_tpu_torch.io import read_image

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_group_set(tmp, 'ts2d-v9-test', GROUPS)
        with TS2D(key='ts2d-v9-test', use_remote=False, fetch_remote=False,
                  local=tmp, device='cpu') as tool:
            fused_ok = tool._fused is not None
            for name in assets:
                img = read_image(_asset_path(name))
                fused = tool.predict(img).get_segmentation()
                tool._fused, saved = None, tool._fused
                for m in tool.models.values():
                    m.start('cpu', wait=True)
                permodel = tool.predict(img).get_segmentation()
                tool._fused = saved
                results[name] = float((fused.array == permodel.array).mean())
    ok = bool(results) and all(v > 0.9999 for v in results.values())
    return {'ok': ok and fused_ok, 'fused_path_active': fused_ok,
            'agreement': results}


def asset_2d(name):
    """A bundled asset as the 2D float input and (y, x) spacing the engine
    takes: a 3D CT reoriented to RAI and projected (numpy MIP + AIP), a
    projected or 2D image as it is (tests/test_019's ``_asset_2d``)."""
    from totalsegmentator2d_tpu_torch.io import read_image
    from totalsegmentator2d_tpu_torch.ops.geometry import reorient

    img = read_image(_asset_path(name))
    sp = img.spacing
    if name == 'sample_s0521':
        img = reorient(img, 'RAI')
        vol = np.asarray(img.array, np.float32)
        arr = np.stack([vol.max(axis=1), vol.mean(axis=1)], axis=-1)
        spacing = (img.spacing[2], img.spacing[0])
    else:
        arr = np.asarray(img.array, np.float32)
        if arr.ndim == 4:
            arr = arr.reshape([s for s in arr.shape[:-1] if s != 1]
                              + [arr.shape[-1]])
            spacing = (sp[2], sp[0])
        else:
            if arr.ndim == 2:
                arr = arr[..., None]
            spacing = (sp[1], sp[0])
    return np.ascontiguousarray(arr.astype(np.float32)), spacing


def _solo(name, arr, spacing, device='cpu', precision='exact', bar=LOGIT_BAR,
          agree_bar=AGREE_BAR, channels=('max', 'mean'), **kw):
    import torch

    from totalsegmentator2d_tpu_torch.inference import InferenceEngine
    spec, nets, sds = build_config(name, channels)
    eng = InferenceEngine(spec, sds, device=device, compute_dtype=(
        torch.bfloat16 if precision == 'fast' else None), **kw)
    try:
        seg, logits, bbox = eng.predict_array(arr, spacing, return_logits=True)
    finally:
        eng.close()
    ref = oracle_predict(arr, spacing, spec, nets, **kw)
    entry = logits_vs_oracle(seg, logits, bbox, ref)
    entry['ok'] = bool(entry['bbox_match']
                       and entry['max_abs_logit_err'] < bar
                       and entry['mask_agreement'] >= agree_bar)
    return entry


def check_full_chain(configs=CONFIGS, assets=ASSETS) -> dict:
    """The per-model engine's whole chain against the oracle, logits and
    masks, on the CPU: the configurations, a multi-tile grid, no
    mirroring, and the bundled assets."""
    RC = _oracle()
    rng = np.random.default_rng(21)
    out = {}
    for name in configs:
        arr, spacing = RC.config_input(name, rng)
        out[name] = _solo(name, arr, spacing)
    if 'multilabel' in configs:
        arr = np.zeros((150, 140, 2), np.float32)
        arr[5:-5, 5:-5] = rng.standard_normal((140, 130, 2)) + 2
        out['multi-tile'] = _solo('multilabel', arr, (1.5, 1.5))
        arr, spacing = RC.config_input('multilabel', rng)
        out['no-mirroring'] = _solo('multilabel', arr, spacing,
                                    use_mirroring=False)
    on_assets = {}
    for name in assets:
        arr, spacing = asset_2d(name)
        channels = ('max', 'mean') if arr.shape[-1] == 2 else ('xray',)
        on_assets[name] = _solo('multilabel', arr, spacing, bar=1e-2,
                                channels=channels)
    ok = all(e['ok'] for e in list(out.values()) + list(on_assets.values()))
    return {'ok': ok, 'configs': out, 'assets': on_assets}


def check_full_chain_batched(configs=CONFIGS) -> dict:
    """The micro-batched program (4 scans in one dispatch, its one-pass
    statistics) against the oracle, per scan."""
    from totalsegmentator2d_tpu_torch.inference import EnsembleEngine
    RC = _oracle()
    B = 4
    rng = np.random.default_rng(33)
    out = {}
    for name in configs:
        spec, nets, sds = build_config(name)
        eng = EnsembleEngine([spec], [sds], auto_batch=B, device='cpu')
        try:
            eng.set_batch_linger(30_000.0)  # a full batch
            pairs = [RC.config_input(name, rng) for _ in range(B)]
            handles = [eng.predict_array_async(a, sp) for a, sp in pairs]
            segs = [eng.finish_array(h) for h in handles]
            occ = eng._batcher.stats()['batch_occupancy']
        finally:
            eng.close()
        worst = None
        for (arr, sp), seg in zip(pairs, segs):
            ref_seg, ref_logits, bbox = oracle_predict(arr, sp, spec, nets)
            m = mask_vs_oracle(seg, ref_seg, ref_logits, bbox, spec,
                               LOAD_MARGIN)
            if worst is None or m['mask_agreement'] < worst['mask_agreement']:
                worst = m
        entry = {'batched_scans': sum((i + 1) * c for i, c in enumerate(occ)
                                      if i > 0), **worst}
        entry['ok'] = (entry['batched_scans'] >= 2
                       and entry['mask_agreement'] >= AGREE_BAR
                       and entry['flips_borderline_only'])
        out[name] = entry
    return {'ok': all(e['ok'] for e in out.values()), 'max_batch': B,
            'configs': out}


def check_full_chain_quantized(configs=CONFIGS) -> dict:
    """The quantized-shape bucket program (pad_quantum 32) against the
    oracle."""
    from totalsegmentator2d_tpu_torch.inference import EnsembleEngine
    RC = _oracle()
    rng = np.random.default_rng(34)
    out = {}
    for name in configs:
        arr, spacing = RC.config_input(name, rng)
        spec, nets, sds = build_config(name)
        eng = EnsembleEngine([spec], [sds], pad_quantum=32, device='cpu')
        seg = eng.predict_array(arr, spacing)
        ref_seg, ref_logits, bbox = oracle_predict(arr, spacing, spec, nets)
        entry = mask_vs_oracle(seg, ref_seg, ref_logits, bbox, spec,
                               LOAD_MARGIN)
        entry['ok'] = (entry['mask_agreement'] >= AGREE_BAR
                       and entry['flips_borderline_only'])
        out[name] = entry
    return {'ok': all(e['ok'] for e in out.values()), 'pad_quantum': 32,
            'configs': out}


def check_full_chain_bench_arch() -> dict:
    """The whole chain at the 6-stage architecture (256^2 patch, features
    32-512, 26 labels) on a 350 x 280 input, against the oracle."""
    arr, spacing = _oracle().config_input('bench-arch',
                                          np.random.default_rng(35))
    return _solo('bench-arch', arr, spacing, bar=DEVICE_BAR)


OFFLINE = {
    'gaussian-window': check_gaussian_window,
    'crop-roundtrip': check_crop_roundtrip,
    'volume-crop': check_volume_crop,
    'resample-order': check_resample_order,
    'fused-vs-permodel': check_fused_vs_permodel,
    'full-chain': check_full_chain,
    'full-chain-batched': check_full_chain_batched,
    'full-chain-quantized': check_full_chain_quantized,
    'full-chain-bench-arch': check_full_chain_bench_arch,
}
def run_offline(checks=None, configs=CONFIGS, assets=None) -> dict:
    """The offline checks (all, or those named), each caught and reported
    on its own; ``configs`` and ``assets`` narrow the checks that run over
    configurations and bundled assets (None: each check's own assets)."""
    kw = {name: {'configs': configs} for name in (
        'full-chain', 'full-chain-batched', 'full-chain-quantized')}
    if assets is not None:
        kw['full-chain']['assets'] = assets
        kw['fused-vs-permodel'] = {'assets': assets}
    report = {'mode': 'offline', 'checks': {}}
    for name in checks or OFFLINE:
        try:
            report['checks'][name] = OFFLINE[name](**kw.get(name, {}))
        except Exception as ex:
            report['checks'][name] = {'ok': False,
                                      'error': f'{type(ex).__name__}: {ex}'}
        print(f'{name}: {report["checks"][name]}', file=sys.stderr)
    report['ok'] = all(c.get('ok') for c in report['checks'].values())
    return report


# -- the card ---------------------------------------------------------------

def check_device_full_chain(device='cuda', configs=CONFIGS) -> dict:
    """The 6 configurations' whole chain on ``device`` against the oracle
    on the CPU (tools/parity.py's device check): logit drift < 2e-2, the
    bbox, borderline-only flips. The agreement is reported, not held: the
    random-weight nets put far more pixels at the decision boundary than
    trained checkpoints do."""
    from totalsegmentator2d_tpu_torch.inference import InferenceEngine
    RC = _oracle()
    rng = np.random.default_rng(21)
    out = {}
    for name in configs:
        arr, spacing = RC.config_input(name, rng)
        spec, nets, sds = build_config(name)
        eng = InferenceEngine(spec, sds, device=device)
        try:
            seg, logits, bbox = eng.predict_array(arr, spacing,
                                                  return_logits=True)
        finally:
            eng.close()
        out[name] = device_entry(seg, logits, bbox,
                                 oracle_predict(arr, spacing, spec, nets), spec)
    return {'ok': all(e['ok'] for e in out.values()), 'device': str(device),
            'configs': out}


def run_device(device) -> dict:
    check = check_device_full_chain(device)
    print(f'full-chain-device: {check}', file=sys.stderr)
    return {'mode': 'device', 'checks': {'full-chain-device': check},
            'ok': check['ok']}


# -- real mode ---------------------------------------------------------------

def run_real(models_root, key, golden_dir, out_dir, device=None,
             assets=ASSETS) -> dict:
    """A local database predicts the bundled assets; each result is
    written to ``out_dir`` and, where ``golden_dir`` holds
    ``<asset>.seg.nrrd``, scored per label (Dice) and per voxel."""
    from totalsegmentator2d_tpu_torch.api import TS2D
    from totalsegmentator2d_tpu_torch.eval import dice_per_label
    from totalsegmentator2d_tpu_torch.io import read_image

    os.makedirs(out_dir, exist_ok=True)
    report = {'mode': 'real', 'key': key, 'assets': {}}
    with TS2D(key=key, use_remote=False, fetch_remote=False,
              local=models_root, device=device) as tool:
        for name in assets:
            entry = {}
            try:
                res = tool.predict(_asset_path(name))
                res.save(out_dir, name=name, models='final',
                         targets='segmentation', content='file')
                entry['predicted'] = True
                golden = (os.path.join(golden_dir, f'{name}.seg.nrrd')
                          if golden_dir else None)
                if golden and os.path.exists(golden):
                    pred, gold = res.get_segmentation(), read_image(golden)
                    scores = dice_per_label(pred, gold, device=device)
                    entry['per_label_dice'] = scores
                    entry['mean_dice'] = float(np.mean(list(scores.values())))
                    entry['voxel_agreement'] = (
                        float((pred.array == gold.array).mean())
                        if pred.array.shape == gold.array.shape else 0.0)
                    entry['diverging_labels'] = sorted(
                        n for n, s in scores.items() if s < 0.999)
            except Exception as ex:  # keep going; report per asset
                entry['error'] = f'{type(ex).__name__}: {ex}'
            report['assets'][name] = entry
    report['ok'] = all('error' not in e for e in report['assets'].values())
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--models', default=None,
                    help='local model database root (real mode)')
    ap.add_argument('--key', default='ts2d')
    ap.add_argument('--golden', default=None,
                    help='directory of reference-produced <asset>.seg.nrrd')
    ap.add_argument('--outdir', default='parity_out',
                    help='where real mode writes its segmentations')
    ap.add_argument('--device', default=None,
                    help="'cuda': the whole chain on the card against the "
                         'oracle; in real mode the device to predict on')
    ap.add_argument('--checks', default=None,
                    help='offline checks to run, comma separated (default '
                         'all)')
    ap.add_argument('--configs', default=','.join(CONFIGS),
                    help='configurations of the per-config checks')
    ap.add_argument('--assets', default=None,
                    help='bundled assets of full-chain and fused-vs-permodel, '
                         'comma separated (default: each check\'s own)')
    ap.add_argument('--out', default=None,
                    help='the JSON report (default: stdout)')
    args = ap.parse_args(argv)
    configs = tuple(c for c in args.configs.split(',') if c)
    if args.models:
        report = run_real(args.models, args.key, args.golden, args.outdir,
                          args.device)
    elif args.device:
        report = run_device(args.device)
    else:
        checks = args.checks.split(',') if args.checks else None
        assets = tuple(args.assets.split(',')) if args.assets else None
        unknown = sorted((set(checks or ()) - set(OFFLINE))
                         | (set(configs) - set(CONFIGS))
                         | (set(assets or ()) - set(ASSETS)))
        if unknown:
            ap.error(f'unknown checks, configs or assets: {unknown}')
        report = run_offline(checks, configs, assets)
    text = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(text)
    else:
        print(text)
    print(json.dumps({'ok': bool(report['ok']), 'report': args.out or
                      'stdout'}))
    return 0 if report['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
