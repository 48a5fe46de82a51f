"""Model key grammar and the local model database.

Key grammar: ``<model>-<dataset>-<config>_<group>``. The group is split on
the last underscore; model names match component-wise by prefix on
'-'-separated parts, so 'ts2d-v2' matches 'ts2d-v2-ep4000b2'. Revisions are
directories named ``r%03d``. :class:`FileDataBase` is the store
``<root>/<model>_<group>/r###/``; the remote registry is not ported yet.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, Iterator, Optional, Tuple

from ..utils.logging import warn
from ..utils.params import parse_int


def decompose_model_key(key: str) -> Tuple[str, Optional[str]]:
    """'ts2d-v2-ep4000b2_cardiac' -> ('ts2d-v2-ep4000b2', 'cardiac')."""
    if '_' in key:
        model, group = key.rsplit('_', 1)
        return model, group
    return key, None


def revision_str(revision) -> str:
    return f'r{revision:03d}' if isinstance(revision, int) else str(revision)


def parse_revision(rn) -> Optional[int]:
    if isinstance(rn, int):
        return rn
    s = str(rn)
    return parse_int(s[1:] if s.startswith('r') else s)


def match_model_name(pattern: Optional[str], model: str) -> bool:
    """Component-wise prefix match: each '-'-part of the pattern must equal
    the corresponding part of the model name (empty parts match anything).
    A pattern with more non-empty components than the model does not
    match."""
    if pattern is None:
        return True
    if '-' in model:
        pat = pattern.split('-')
        parts = model.split('-')
        if len(pat) > len(parts) and any(pat[len(parts):]):
            return False
        for i in range(len(parts)):
            if i < len(pat) and pat[i] and pat[i] != parts[i]:
                return False
        return True
    return model == pattern


class FileDataBase:
    """Local on-disk store: ``<root>/<model>_<group>/r###/``."""

    def __init__(self, root: str):
        self._root = root

    @property
    def root(self) -> str:
        return self._root

    def _enumerate(self) -> Iterator[Tuple[str, str, int, str]]:
        for dn in glob(os.path.join(self._root, '*', 'r*')):
            rel = os.path.relpath(dn, self._root)
            modeldir, rn = os.path.split(rel)
            rev = parse_revision(rn)
            model, group = decompose_model_key(modeldir)
            if rev is None or group is None:
                warn(f'Skipping malformed database entry {rel!r}')
                continue
            yield model, group, rev, dn

    def list(self, model: Optional[str] = None, group: Optional[str] = None,
             key: Optional[str] = None, revision=None) -> Dict[tuple, str]:
        if key is not None:
            model, group = decompose_model_key(key)
        if isinstance(revision, str):
            revision = parse_revision(revision)
        res = {}
        for m, g, r, path in self._enumerate():
            if (match_model_name(model, m)
                    and (revision is None or revision == r)
                    and (group is None or group == g)):
                res[(m, g, r)] = path
        return res

    def has(self, **kw) -> bool:
        return bool(self.list(**kw))

    def ids(self, **kw) -> list:
        return sorted({f'{m}_{g}' for (m, g, r) in self.list(**kw)})

    def models(self, **kw) -> list:
        return sorted({m for (m, g, r) in self.list(**kw)})

    def latest(self, **kw) -> Optional[int]:
        revs = sorted({r for (m, g, r) in self.list(**kw)})
        return revs[-1] if revs else None

    def get(self, **kw) -> dict:
        """Details of the first (lexicographically by id) matching model."""
        entries = sorted((f'{m}_{g}', (m, g, r, p))
                         for (m, g, r), p in self.list(**kw).items())
        if not entries:
            raise LookupError(f'No model matches {kw}')
        id_, (m, g, r, p) = entries[0]
        return {'id': id_, 'model': m, 'group': g, 'revision': r, 'path': p}

    def resource_path(self, key: str, revision: Optional[int] = None) -> Optional[str]:
        path = os.path.join(self._root, str(key).lower().strip())
        if revision is not None:
            path = os.path.join(path, revision_str(revision))
        return path if os.path.exists(path) else None
