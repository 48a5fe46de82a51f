"""Packaged configuration and registry loaders.

The package ships three data files:
 - ``config.json``      default model key + alias resolve map
 - ``shared.json``      remote model registry {model: {revision: {group: url}}}
 - ``label-colors.csv`` label name -> hex color rows

:func:`get_shared_urls` can refresh the registry from the upstream
repository (with ``urllib``), falling back to the packaged copy.
"""

from __future__ import annotations

import csv
import functools
import json
import os

from .files import get_package_data_dir, read_json
from .logging import warn

#: the upstream registry, fetched by get_shared_urls(fetch_remote=True)
SHARED_URL = ('https://raw.githubusercontent.com/risc-mi/totalsegmentator2D/'
              'main/ts2d/data/shared.json')


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


def get_test_model(kind: str = 'single') -> str:
    """The packaged test model key of ``kind`` ('single', 'single-xr',
    'multi')."""
    return _get_config()[f'default-test-model-{kind}']


def get_model_resolve_map() -> dict:
    return dict(_get_config().get('default-resolve', {}))


def get_shared_urls(fetch_remote: bool = False, timeout: float = 10.0) -> dict:
    """The remote model registry. With ``fetch_remote`` the latest registry
    is fetched from the upstream repository's main branch; any failure
    (no network, an HTTP error, a body that is not JSON) falls back to the
    packaged copy with a warning."""
    if fetch_remote:
        import urllib.request
        try:
            with urllib.request.urlopen(SHARED_URL, timeout=timeout) as r:
                return json.loads(r.read())
        except Exception as ex:  # noqa: BLE001 — any failure means offline
            warn(f'Failed to fetch the remote registry ({ex}); using the '
                 f'local copy.', once=True)
    return read_json(_data_path('shared.json'))
