"""Model zoo: key resolution and loading from the local database.

Alias-chain resolution from config.json, component-prefix key matching, and
unique-model selection (the lexicographically first base model, then all of
its groups), as in the reference tool. Downloading from the remote registry
is not ported yet.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..utils.config import get_model_resolve_map
from ..utils.files import get_local_models_root, read_json
from ..utils.params import dict_merge
from .database import FileDataBase
from .model import HostedModel


class Zoo:
    def __init__(self, local: Optional[str] = None):
        """:param local: local database root; None -> ~/.ts2d/models"""
        self._local = FileDataBase(str(local if local is not None
                                       else get_local_models_root()))

    @property
    def local(self) -> FileDataBase:
        return self._local

    def resolve(self, key: str, unique_model: bool = False) -> List[str]:
        """Resolve a key to model ids, following the alias map
        (ts2d -> ts2d-v2 -> ts2d-v2-ep4000b2) and optionally reducing to the
        first base model's full group set."""
        aliases = get_model_resolve_map()
        seen = set()
        while key in aliases and key not in seen:
            seen.add(key)
            key = aliases[key]
        ids = self._local.ids(key=key)
        if len(ids) > 1 and unique_model:
            return self._local.ids(model=self._local.models(key=key)[0])
        return ids

    def access(self, id: str, revision: Optional[int] = None) -> dict:
        """The model's info, with its local root path (latest revision
        unless one is given)."""
        ids = self.resolve(id)
        if len(ids) > 1:
            raise LookupError(f'The model id {id!r} is ambiguous '
                              f'(matches {", ".join(ids)})')
        if not self._local.has(key=id, revision=revision):
            raise LookupError(f'No pretrained model {id!r} in the local '
                              f'database {self._local.root!r}')
        if revision is None:
            revision = self._local.latest(key=id)
        info = self._local.get(key=id, revision=revision)
        info['root'] = self._local.resource_path(info['id'], revision)
        return info

    def load(self, id: str, param: Optional[dict] = None,
             revision: Optional[int] = None) -> HostedModel:
        """Access a model, merge its model.json with the caller's params, and
        return its HostedModel."""
        config = self.access(id=id, revision=revision)
        root = config['root']
        if not root or not os.path.exists(root):
            raise RuntimeError(f'Failed to locate the model root for {id!r}')
        jpath = os.path.join(root, 'model.json')
        if os.path.exists(jpath):
            config = dict_merge(config, read_json(jpath))
        config['param'] = dict_merge(config.get('param'), param or {})
        return HostedModel(config)
