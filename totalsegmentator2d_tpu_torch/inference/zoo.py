"""Model zoo: key resolution, the local database, download from the remote
registry.

Alias-chain resolution from config.json, component-prefix key matching,
unique-model selection (the lexicographically first base model, then all
of its groups), local-first access with download-on-miss and the
latest-revision logic, as in the reference tool.
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

from ..utils.config import get_model_resolve_map, get_shared_urls
from ..utils.files import get_local_models_root, read_json
from ..utils.logging import log
from ..utils.params import dict_merge
from .database import DataBase, FileDataBase, URLDataBase
from .model import HostedModel


class Zoo:
    def __init__(self, remote: Union[DataBase, None, bool] = None,
                 local: Union[DataBase, str, None] = None):
        """
        :param remote: the remote database; None -> the packaged URL
            registry, False -> none (local only)
        :param local: a local database or its root; None -> ~/.ts2d/models
        """
        if local is None:
            local = get_local_models_root()
        if remote is False:
            remote = None
        elif remote is None:
            remote = URLDataBase(get_shared_urls())
        self._remote = remote
        self._local = local if isinstance(local, DataBase) else \
            FileDataBase(str(local), readonly=False)

    @property
    def remote(self) -> Optional[DataBase]:
        return self._remote

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
        db = self._remote if self._remote is not None else self._local
        ids = db.ids(key=key)
        if not ids and db is not self._local:
            # a model present locally but absent from the registry (trained
            # or shared by hand) resolves without use_remote=False; the
            # reference tool consults only the remote when it has one
            db = self._local
            ids = db.ids(key=key)
        if len(ids) > 1 and unique_model:
            models = db.models(key=key)
            if not models:
                raise LookupError(f'No models resolved for key {key!r}')
            return db.ids(model=models[0])
        return ids

    def access(self, id: str, revision: Optional[int] = None) -> dict:
        """Make the model locally available (downloading it on a miss) and
        return its info with its local root path."""
        ids = self.resolve(id)
        if len(ids) > 1:
            raise LookupError(f'The model id {id!r} is ambiguous '
                              f'(matches {", ".join(ids)})')
        if self._remote is not None and revision is None:
            if self._remote.has(key=id):
                revision = self._remote.latest(key=id)

        if self._local.has(key=id, revision=revision):
            if revision is None:
                revision = self._local.latest(key=id)
        elif self._remote is not None and self._remote.has(key=id,
                                                           revision=revision):
            if revision is None:
                revision = self._remote.latest(key=id)
            log(f'Copying pretrained model {id} (r{revision:03d}) from remote '
                f'to local database...')
            self._remote.copy(self._local.root, key=id, revision=revision)
            if not self._local.has(key=id, revision=revision):
                raise RuntimeError(
                    f'Model {id!r} missing from the local database after '
                    f'copying')
        else:
            where = 'remote or local' if self._remote is not None else 'local'
            raise LookupError(f'No pretrained model {id!r} in the {where} '
                              f'database')

        info = self._local.get(key=id, revision=revision)
        info['root'] = self._local.resource_path(info['id'], revision)
        return info

    def load(self, id: str, param: Optional[dict] = None,
             revision: Optional[int] = None,
             interface: str = 'hosted') -> HostedModel:
        """Access a model, merge its model.json with the caller's params, and
        return its HostedModel.

        ``interface`` is the reference's: 'process' / 'prc' and the
        service names give the same in-process model (there is no worker
        process to isolate a card in); any other value raises."""
        if interface.lower() not in ('hosted', 'process', 'prc', 'svc',
                                     'server'):
            raise ValueError(f'Invalid model interface: {interface}')
        config = self.access(id=id, revision=revision)
        root = config['root']
        if not root or not os.path.exists(root):
            raise RuntimeError(f'Failed to locate the model root for {id!r}')
        jpath = os.path.join(root, 'model.json')
        if os.path.exists(jpath):
            config = dict_merge(config, read_json(jpath))
        config['param'] = dict_merge(config.get('param'), param or {})
        return HostedModel(config)

    def clear(self, key: Optional[str] = None, revision: Optional[int] = None):
        self._local.clear(key=key, revision=revision)
