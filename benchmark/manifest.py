"""Resolves a cell of ``BENCHMARK.json`` to its files, by name.

A cell names a configuration (``benchmark/configs/<config>.json``) and a
traffic mix (``benchmark/traffic/<traffic>.json``); its correctness limits
are ``benchmark/workloads/<cell>.json``; each metric that applies to it is
read by ``benchmark/metrics/<metric>.py``. Which metrics apply comes from
``BENCHMARK.json`` alone: a metric without a ``workloads`` key applies to
every cell. So a configuration, mix, cell or metric is added as files and
entries, and no file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List


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


def cell(root: str, name: str) -> Cell:
    """The cell called ``name``, its files read. Raises KeyError for a name
    that BENCHMARK.json does not list."""
    m = manifest(root)
    found = [w for w in m['workloads'] if w['name'] == name]
    if not found:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    w = found[0]
    d = bench_dir(root)
    config_path = os.path.join(d, 'configs', f"{w['config']}.json")
    return Cell(
        name=name, chips=int(w['chips']), config_path=config_path,
        config=_load(config_path),
        traffic=_load(os.path.join(d, 'traffic', f"{w['traffic']}.json")),
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
