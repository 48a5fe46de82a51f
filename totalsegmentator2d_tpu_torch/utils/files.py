"""File, path and JSON helpers."""

from __future__ import annotations

import json
import os
import shutil


def read_json(path: str):
    with open(path, 'r', encoding='utf-8') as f:
        return json.load(f)


def write_json(path: str, data, indent: int = 2) -> None:
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(data, f, indent=indent)


def mkdirs(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def rmdirs(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


def removeall(path: str) -> None:
    if os.path.isdir(path):
        rmdirs(path)
    elif os.path.exists(path):
        try:
            os.remove(path)
        except OSError:
            pass


def isemptydir(path: str) -> bool:
    return os.path.isdir(path) and not os.listdir(path)


def get_home_dir() -> str:
    return os.environ.get('TS2D_HOME') or os.path.join(os.path.expanduser('~'), '.ts2d')


def get_local_models_root() -> str:
    return os.path.join(get_home_dir(), 'models')


def get_package_data_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'data')
