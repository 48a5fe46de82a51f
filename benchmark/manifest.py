"""Resolves a cell of ``BENCHMARK.json`` to its files, by name.

A cell names a configuration (``benchmark/configs/<config>.json``) and a
traffic mix (``benchmark/traffic/<traffic>.json``); its correctness limits
are ``benchmark/workloads/<cell>.json``; each metric that applies to it is
read by ``benchmark/metrics/<metric>.py``. Which metrics apply comes from
``BENCHMARK.json`` alone: a metric without a ``workloads`` key applies to
every cell. So a configuration, mix, cell or metric is added as files and
entries, and no file that is there changes.

A mix is of one of two kinds, by the rank of its ``volumes`` entries:

- 3D CT volumes, ``[z, y, x]`` at ``spacing_xyz`` (mm, ITK order): int16
  torso phantoms (phantom.torso_ct), sent as volumes; the program and the
  reference read their coronal MIP + AIP;
- native 2D images, ``[rows, cols]`` at ``spacing_xy`` (mm, columns
  first): int16 chest radiographs (phantom.chest_xr), sent as 2D images;
  the program and the reference read each as its own single channel.

Both are compared with the reference alike (check.py).

A configuration names its network by an optional ``network`` key
(check_config): ``PlainConvUNet`` when it is absent, with
``n_conv_per_stage`` convs a stage, encoder and decoder; or
``ResidualEncoderUNet``, with ``n_blocks_per_stage`` (one count per stage)
and ``n_conv_per_stage_decoder`` (an int). The model database, the
reference and the operation counts build whichever it names.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence


@dataclass
class Cell:
    name: str
    chips: int
    config_path: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_dir(root: str) -> str:
    return os.path.join(root, 'benchmark')


def manifest(root: str) -> dict:
    return _load(os.path.join(root, 'BENCHMARK.json'))


def applies(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


# a mix's spacing key by the rank of its entries
SPACING = {2: 'spacing_xy', 3: 'spacing_xyz'}


def spacing(mix: dict) -> Sequence[float]:
    """The mix's spacing in ITK order: a CT mix's (x, y, z), a 2D mix's
    (x, y)."""
    return mix[SPACING[len(mix['volumes'][0])]]


def check_mix(name: str, mix: dict) -> None:
    """Raises ValueError, naming the key, for a mix whose ``volumes`` are
    not all 3D or all 2D, or that lacks the spacing of its kind."""
    ranks = sorted({len(v) for v in mix.get('volumes') or [[]]})
    if len(ranks) != 1 or ranks[0] not in SPACING:
        raise ValueError(
            f"traffic {name!r}: 'volumes' must be all [z, y, x] (CT) or all "
            f"[rows, cols] (2D), found entries of {ranks} sizes")
    key = SPACING[ranks[0]]
    if len(mix.get(key) or ()) != ranks[0]:
        raise ValueError(f"traffic {name!r}: a mix of {ranks[0]}D "
                         f"'volumes' gives {ranks[0]} sizes in {key!r}")


PLAIN, RESIDUAL = 'PlainConvUNet', 'ResidualEncoderUNet'
# the networks a configuration may name -> the keys each needs: its convs
# or blocks a stage
NETWORKS = {PLAIN: ('n_conv_per_stage',),
            RESIDUAL: ('n_blocks_per_stage', 'n_conv_per_stage_decoder')}


def network(config: dict) -> str:
    return config.get('network', PLAIN)


def _count(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 1


def check_config(name: str, config: dict) -> None:
    """Raises ValueError, naming the key, for a configuration whose
    ``network`` is not one of NETWORKS, that lacks a key its network needs,
    or whose counts of convs or blocks are not whole numbers from 1, one
    per stage of ``features_per_stage`` in ``n_blocks_per_stage``."""
    net = network(config)
    if net not in NETWORKS:
        raise ValueError(f"configuration {name!r}: 'network' {net!r} is not "
                         f"one of {sorted(NETWORKS)}")
    for key in NETWORKS[net]:
        if key not in config:
            raise ValueError(f"configuration {name!r}: a {net} needs "
                             f"{key!r}")
    if net == RESIDUAL:
        blocks = config['n_blocks_per_stage']
        stages = len(config['features_per_stage'])
        if not isinstance(blocks, list) or len(blocks) != stages:
            raise ValueError(
                f"configuration {name!r}: 'n_blocks_per_stage' must list one "
                f"count per stage of 'features_per_stage' ({stages})")
    for key in NETWORKS[net]:
        counts = (config[key] if key == 'n_blocks_per_stage'
                  else [config[key]])
        if not all(_count(c) for c in counts):
            raise ValueError(f"configuration {name!r}: {key!r} must count "
                             f"in whole numbers from 1")


def cell(root: str, name: str) -> Cell:
    """The cell called ``name``, its files read. Raises KeyError for a name
    that BENCHMARK.json does not list, ValueError for a mix that check_mix
    or a configuration that check_config refuses."""
    m = manifest(root)
    found = [w for w in m['workloads'] if w['name'] == name]
    if not found:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    w = found[0]
    d = bench_dir(root)
    config_path = os.path.join(d, 'configs', f"{w['config']}.json")
    mix = _load(os.path.join(d, 'traffic', f"{w['traffic']}.json"))
    check_mix(w['traffic'], mix)
    config = _load(config_path)
    check_config(w['config'], config)
    return Cell(
        name=name, chips=int(w['chips']), config_path=config_path,
        config=config, traffic=mix,
        limits=_load(os.path.join(d, 'workloads', f'{name}.json'))['limits'],
        end_to_end=[e for e in m['end_to_end'] if applies(e, name)],
        per_layer=[p for p in m['per_layer'] if applies(p, name)])


def reader(root: str, metric: str) -> Callable:
    """The ``read(run)`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(bench_dir(root), 'metrics', f'{metric}.py')
    spec = importlib.util.spec_from_file_location(
        'benchmark_metric_' + metric.replace('.', '_').replace('-', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
