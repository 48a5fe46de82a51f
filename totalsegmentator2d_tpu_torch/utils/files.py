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


def enumerate_files(root: str, skip_private: bool = True):
    """Every file under ``root``, recursively, skipping '_'-prefixed
    directories unless ``skip_private`` is off."""
    for dirpath, dirnames, filenames in os.walk(root):
        if skip_private:
            dirnames[:] = [d for d in dirnames if not d.startswith('_')]
        for fn in sorted(filenames):
            yield os.path.join(dirpath, fn)


def get_home_dir() -> str:
    return os.environ.get('TS2D_HOME') or os.path.join(os.path.expanduser('~'), '.ts2d')


def get_local_models_root() -> str:
    return os.path.join(get_home_dir(), 'models')


def get_package_data_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'data')


def split_image_name(filename: str):
    """'name.ext' split at its first dot, so that a multi-part medical-image
    extension stays whole ('a.nii.gz' -> ('a', 'nii.gz'))."""
    base = os.path.basename(filename)
    if '.' not in base:
        return base, ''
    name, ext = base.split('.', 1)
    return name, ext
