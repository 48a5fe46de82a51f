"""The network a configuration names: nnU-Net's ResidualEncoderUNet in the
plain reference against its equations, its state-dict names, a residual
configuration added as files only (its database, reference and counts on
the CPU), and the committed PlainConvUNet configurations' database, weights
and counts pinned to what they were before the network was a key."""

import hashlib
import json
import os
import shutil

import pytest
import torch
import torch.nn.functional as F

from benchmark import arith, database, manifest, phantom, reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = reference.ResArch(in_channels=2, out_channels=3, features=(4, 8, 16),
                          blocks=(1, 2, 2), n_conv_decoder=1)


def _equations(sd, x, arch):
    """ResidualEncoderUNet's forward written from its equations, reading
    the weights by their checkpoint names: the stem act(IN(conv(x))); a
    block act(IN(conv2(act(IN(conv1_s(x))))) + skip(x)), skip the identity
    or AvgPool(s) where strided, then IN(conv1x1(.)) where the channels
    change; the decoder's transposed conv, concatenated skip and convs; the
    last head."""
    def conv_norm(name, t, stride=1):
        w = sd[f'{name}.conv.weight']
        t = F.conv2d(t, w, sd.get(f'{name}.conv.bias'), stride=stride,
                     padding=w.shape[-1] // 2)
        return F.instance_norm(t, weight=sd[f'{name}.norm.weight'],
                               bias=sd[f'{name}.norm.bias'], eps=1e-5)

    def act(t):
        return F.leaky_relu(t, 0.01)

    x = act(conv_norm('encoder.stem.convs.0', x))
    skips = []
    for s, n in enumerate(arch.blocks):
        for b in range(n):
            name = f'encoder.stages.{s}.blocks.{b}'
            stride = 2 if s > 0 and b == 0 else 1
            r = conv_norm(f'{name}.conv2',
                          act(conv_norm(f'{name}.conv1', x, stride)))
            skip = F.avg_pool2d(x, stride) if stride > 1 else x
            if skip.shape[1] != r.shape[1]:
                skip = conv_norm(f'{name}.skip.{int(stride > 1)}', skip)
            x = act(r + skip)
        skips.append(x)
    for d in range(len(arch.features) - 1):
        x = F.conv_transpose2d(x, sd[f'decoder.transpconvs.{d}.weight'],
                               sd[f'decoder.transpconvs.{d}.bias'], stride=2)
        x = torch.cat([x, skips[-2 - d]], dim=1)
        for i in range(arch.n_conv_decoder):
            x = act(conv_norm(f'decoder.stages.{d}.convs.{i}', x))
    d = len(arch.features) - 2
    return F.conv2d(x, sd[f'decoder.seg_layers.{d}.weight'],
                    sd[f'decoder.seg_layers.{d}.bias'])


def _small_net(arch=SMALL, seed=3):
    state = reference.init_state(arch, torch.Generator().manual_seed(seed),
                                 -2.2, 'cpu')
    net = reference.network(arch)
    net.load_state_dict(state)
    return net.eval(), state


def test_the_residual_reference_is_its_equations():
    net, state = _small_net()
    assert isinstance(net, reference.RefResUNet)
    x = torch.randn(2, 2, 32, 32, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = net(x)
        want = _equations(state, x, SMALL)
    assert got.shape == (2, 3, 32, 32)
    assert float((got - want).abs().max()) <= 1e-6
    # the controls round every operand, the skips' 1x1 convs included
    with torch.no_grad():
        assert not torch.equal(net(x, 'tf32'), got)


@pytest.mark.parametrize('features', [(4, 8, 16), (4, 8, 8)])
def test_the_residual_state_dict(features):
    """The names and shapes of dynamic_network_architectures, without the
    aliases; an identity skip exactly where a block keeps its stride at 1
    and its channels, a pool alone where it is strided and keeps them."""
    arch = reference.ResArch(2, 3, features, (1, 2, 2), 1)
    net, state = _small_net(arch)
    shapes = {k: tuple(v.shape) for k, v in state.items()}
    assert set(state) == set(net.state_dict())
    assert shapes['encoder.stem.convs.0.conv.weight'] == (4, 2, 3, 3)
    assert shapes['encoder.stages.0.blocks.0.conv1.conv.weight'] == (
        4, 4, 3, 3)
    assert shapes['encoder.stages.1.blocks.0.conv1.conv.weight'] == (
        8, 4, 3, 3)
    assert shapes['encoder.stages.1.blocks.0.skip.1.conv.weight'] == (
        8, 4, 1, 1)
    assert 'encoder.stages.1.blocks.0.skip.1.conv.bias' not in state
    assert shapes['encoder.stages.1.blocks.0.skip.1.norm.weight'] == (8,)
    assert shapes['encoder.stages.2.blocks.1.conv2.conv.bias'] == (
        features[2],)
    assert shapes['decoder.transpconvs.0.weight'] == (features[2], 8, 2, 2)
    assert shapes['decoder.stages.0.convs.0.conv.weight'] == (8, 16, 3, 3)
    assert shapes['decoder.stages.1.convs.0.conv.weight'] == (4, 8, 3, 3)
    assert shapes['decoder.seg_layers.1.weight'] == (3, 4, 1, 1)
    assert not any('all_modules' in k or 'decoder.encoder' in k
                   for k in state)
    cin = 4
    for s, stage in enumerate(net.encoder.stages):
        for b, block in enumerate(stage.blocks):
            stride = 2 if s > 0 and b == 0 else 1
            c = cin if b == 0 else features[s]
            kinds = [type(op).__name__ for op in block.skip]
            want = (['AvgPool2d'] if stride > 1 else []) + (
                ['_ConvNorm'] if c != features[s] else [])
            assert kinds == want, (s, b)
            assert (kinds == []) == (stride == 1 and c == features[s])
            assert any(k.startswith(f'encoder.stages.{s}.blocks.{b}.skip.')
                       for k in state) == (c != features[s])
        cin = features[s]
    assert float(state['encoder.stages.1.blocks.0.skip.1.norm.weight']
                 .min()) == 1.0
    # He-normal skips: their std is sqrt(2 / fan_in), as every conv's
    _, wide = _small_net(reference.ResArch(1, 2, (32, 64), (1, 1), 1))
    w = wide['encoder.stages.1.blocks.0.skip.1.conv.weight']
    assert w.shape == (64, 32, 1, 1)
    assert abs(float(w.std()) / (2 / 32) ** 0.5 - 1) < 0.1


# what a small residual configuration gives its database and counts
RESIDUAL = {'name': 'resenc-small', 'network': 'ResidualEncoderUNet',
            'n_blocks_per_stage': [1, 2, 2, 2], 'n_conv_per_stage_decoder': 1,
            'plans_name': 'nnUNetResEncUNetLPlans'}


def test_a_residual_configuration_added_as_files_only(tmp_path, small_root):
    """A ResidualEncoderUNet configuration, a cell and its limits as new
    files and entries: the cell resolves, its database names the class and
    its plans, the reference loads ResEnc nets from it and computes a scan's
    logits, and both metrics count from its network; no file that was
    there changes."""
    root = str(tmp_path / 'root')
    shutil.copytree(small_root, root, ignore=shutil.ignore_patterns('build'))
    b = os.path.join(root, 'benchmark')
    before = {os.path.join(dp, f): open(os.path.join(dp, f), 'rb').read()
              for dp, _, fs in os.walk(b) for f in fs}
    cfg = json.load(open(os.path.join(b, 'configs', 'ts2d-v2-fast.json')))
    del cfg['n_conv_per_stage']
    cfg.update(RESIDUAL)
    json.dump(cfg, open(os.path.join(b, 'configs', 'resenc-small.json'), 'w'))
    json.dump({'limits': {'worst_flip_logit': 0.2, 'flip_share': 1e-3}},
              open(os.path.join(b, 'workloads', 'resenc.solo.json'), 'w'))
    m = json.load(open(os.path.join(root, 'BENCHMARK.json')))
    m['configs'].append({'name': 'resenc-small', 'source': 's',
                         'file': 'benchmark/configs/resenc-small.json',
                         'reduced': [], 'why': 'residual encoder'})
    m['workloads'].append({'name': 'resenc.solo', 'config': 'resenc-small',
                           'traffic': 'solo', 'chips': 1, 'why': 'w'})
    json.dump(m, open(os.path.join(root, 'BENCHMARK.json'), 'w'))

    cell = manifest.cell(root, 'resenc.solo')
    config = cell.config
    names = [f'label{i}' for i in range(sum(config['groups'].values()))]
    db = database.ensure(root, cell.config_path, config, 'cpu', names)
    paths = database.checkpoints(db, config)
    first = paths['cardiac'][0]
    assert f'{os.sep}nnUNetTrainer__nnUNetResEncUNetLPlans__2d{os.sep}' \
        in first
    data_dir = os.path.dirname(os.path.dirname(first))
    plans = json.load(open(os.path.join(data_dir, 'plans.json')))
    arch = plans['configurations']['2d']['architecture']
    assert arch['network_class_name'] == database.RESIDUAL_CLASS
    assert arch['arch_kwargs']['n_blocks_per_stage'] == [1, 2, 2, 2]
    assert arch['arch_kwargs']['n_conv_per_stage_decoder'] == [1, 1, 1]
    assert 'n_conv_per_stage' not in arch['arch_kwargs']
    model = json.load(open(os.path.join(
        os.path.dirname(os.path.dirname(data_dir)), 'model.json')))
    assert model['param']['nnu']['plans'] == 'nnUNetResEncUNetLPlans'

    groups = database.load_nets(db, config, 'cpu')
    assert [len(g) for g in groups] == [1, 1]
    net = groups[0][0]
    assert isinstance(net, reference.RefResUNet)
    sd = torch.load(first, map_location='cpu',
                    weights_only=True)['network_weights']
    assert all(torch.equal(sd[k], v) for k, v in net.state_dict().items())
    image = phantom.volumes([[40, 48, 56]], 2 ** 31 + 3, 'cpu')[0]
    arr, sp = reference.model_input(image, manifest.spacing(cell.traffic))
    got = list(reference.group_logits(
        arr, sp, groups, patch=tuple(config['patch_size']),
        plan_spacing=tuple(config['spacing']), step=config['tile_step_size'],
        mirror_axes=tuple(config['mirror_axes'])))
    assert [g.shape for g in got] == [(40, 56, 3), (40, 56, 4)]
    assert all(bool(torch.isfinite(g).all()) for g in got)

    mfu = manifest.reader(root, 'step_mfu_pct').__globals__['flops_per_scan']
    bound = manifest.reader(root, 'fused_block_roofline').__globals__[
        'bound_s']
    h, w = config['patch_size']
    per_forward = sum(arith.unet_flops(database.arch(config, g), h, w)
                      for g in config['groups'])
    assert mfu(config, 3) == 3 * 4 * per_forward
    plain = dict(config, n_conv_per_stage=2)
    del plain['network']
    assert mfu(config, 3) > mfu(plain, 3)
    blocks = arith.fused_launches(database.arch(config, 'ribs'), (h, w))
    assert bound(config, 2) == 2 * sum(arith.fused_bound_s(8, *x)
                                       for x in blocks)
    for path, data in before.items():
        assert open(path, 'rb').read() == data


# the parent's database, weights and counts of each committed configuration,
# written before the network was a key: sha256 of its files' digests, of
# the checkpoints' contents, and step_mfu_pct's flops_per_scan and
# fused_block_roofline's bound_s (repr) at 2, 4 and 6 tiles
PINNED = {
    'ts2d-v2-fast': (
        'a60beb40ebfbd49d8a907a1631a4b1f112e2a741ebbcf346317158cffecfa4fd',
        '692b5838cba34f9fd57bc20a3571dc0f9820c4d286a1d2b4cdca904229351bc0',
        (1142427746304, 2284855492608, 3427283238912),
        ('0.001147303580189246', '0.0022942756976919248',
         '0.0034412478151946034')),
    'ts2d-v2-exact': (
        'f2cc1e89f126827e212d6b576d8395dbf6c738d8f9713fe2347a0c4da544e0c9',
        '692b5838cba34f9fd57bc20a3571dc0f9820c4d286a1d2b4cdca904229351bc0',
        (1142427746304, 2284855492608, 3427283238912),
        ('0.001147303580189246', '0.0022942756976919248',
         '0.0034412478151946034')),
    'tsxr-v2-fast': (
        'd3a448f0033a080530598e613bf7aa3515eb9778c9a8197d03c2aba1122abc9c',
        '453a2cda6f27cdae9724718e9d39cde9ab7c2a29d2c2ec7bf1c3657ee7fae0a2',
        (1140917796864, 2281835593728, 3422753390592),
        ('0.001147303580189246', '0.0022942756976919248',
         '0.0034412478151946034')),
}


@pytest.mark.parametrize('name', sorted(PINNED))
def test_a_committed_configuration_is_the_parents(name, tmp_path,
                                                  monkeypatch):
    """The database written on the CPU at full size (the checkpoints
    caught rather than saved) and the two metrics' counts."""
    path = os.path.join(ROOT, 'benchmark', 'configs', f'{name}.json')
    config = json.load(open(path))
    saved = []
    monkeypatch.setattr(torch, 'save', lambda obj, p: saved.append((p, obj)))
    db = database.ensure(str(tmp_path), path, config, 'cpu',
                         [f'label{i}' for i in range(117)])
    digests = {os.path.relpath(os.path.join(dp, f), db): hashlib.sha256(
        open(os.path.join(dp, f), 'rb').read()).hexdigest()
        for dp, _, fs in os.walk(db) for f in fs}
    files = hashlib.sha256()
    for rel, digest in sorted(digests.items()):
        files.update(f'{rel} {digest}\n'.encode())
    weights = hashlib.sha256()
    for p, obj in saved:
        weights.update(p.split('.tmp/', 1)[1].encode())
        for k, v in obj['network_weights'].items():
            weights.update(k.encode())
            weights.update(str(tuple(v.shape)).encode())
            weights.update(v.numpy().tobytes())
        weights.update(json.dumps({k: v for k, v in obj.items()
                                   if k != 'network_weights'}).encode())
    mfu = manifest.reader(ROOT, 'step_mfu_pct').__globals__['flops_per_scan']
    bound = manifest.reader(ROOT, 'fused_block_roofline').__globals__[
        'bound_s']
    got = (files.hexdigest(), weights.hexdigest(),
           tuple(mfu(config, t) for t in (2, 4, 6)),
           tuple(repr(bound(config, t)) for t in (2, 4, 6)))
    assert len(saved) == 5
    assert len(digests) == 15
    assert got == PINNED[name]
