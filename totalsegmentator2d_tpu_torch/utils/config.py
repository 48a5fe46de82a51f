"""Packaged configuration loaders.

The package ships three data files:
 - ``config.json``      default model key + alias resolve map
 - ``shared.json``      remote model registry {model: {revision: {group: url}}}
                        (read once the remote database is ported)
 - ``label-colors.csv`` label name -> hex color rows
"""

from __future__ import annotations

import csv
import functools
import os

from .files import get_package_data_dir, read_json


def _data_path(name: str) -> str:
    return os.path.join(get_package_data_dir(), name)


@functools.lru_cache(maxsize=None)
def get_label_colors() -> dict:
    """Label name -> hex color, keys lowercased."""
    colors = {}
    with open(_data_path('label-colors.csv'), newline='') as f:
        for row in csv.DictReader(f):
            label = (row.get('Label') or '').strip().lower()
            color = (row.get('Color') or '').strip()
            if label and color:
                colors[label] = color
    return colors


@functools.lru_cache(maxsize=None)
def _get_config() -> dict:
    return read_json(_data_path('config.json'))


def get_default_model() -> str:
    return _get_config()['default-model']


def get_model_resolve_map() -> dict:
    return dict(_get_config().get('default-resolve', {}))
