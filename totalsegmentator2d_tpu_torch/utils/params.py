"""Dot-key parameter system.

Flat parameter dictionaries use dotted keys (``'nnu.predict.stepsize'``) that
address paths in nested dictionaries. This mirrors the reference framework's
config namespace (reference ts2d/core/util/types.py:60-255) with the full
grammar a reference ``model.json`` may use:

 - ``a.b[0].c`` — bracketed integer indices build *sequences*: after
   nesting, the indexed siblings become a list ordered by index.
 - a node may carry both a leaf value and a subgroup (``{'a': 1,
   'a.b': 2}``): the leaf is stored under the ``'~'`` marker and plain
   access of ``'a'`` returns it; ``'a.~'`` addresses the leaf explicitly
   and a trailing dot (``'a.'``) addresses the subgroup explicitly.
 - key segments are stripped + lowercased when nesting (reference
   nest_dict, types.py:190).

The implementation is fresh (no code shared with the reference); one
deliberate divergence: when the leaf arrives *after* the subgroup
(``{'a.b': 2, 'a': 1}``) the leaf is attached to the node's ``'~'`` as the
docstring of the reference promises, where the reference code drops it on
the parent level instead.
"""

from __future__ import annotations

import re
import typing
from typing import Any, Iterable, Mapping

_MISSING = object()

_SEQ_RE = re.compile(r'^(.*?)\[(-?\d+)\]$')


class _Sequence(dict):
    """Intermediate node for bracketed indices; finalized into a list."""


def split_key(key: str) -> list[str]:
    return [p for p in str(key).split('.') if p]


def _parse_part(part: str, key: str):
    """Split a key segment into (name, index-or-None), validating the
    bracket syntax like the reference (types.py:203-218)."""
    if '[' not in part:
        if ']' in part:
            raise ValueError(f'Invalid sequence syntax in key: {key}')
        return part, None
    m = _SEQ_RE.match(part)
    if not m:
        raise ValueError(f'Invalid sequence syntax in key: {key}')
    name, idx = m.group(1).strip(), int(m.group(2))
    if not name:
        raise ValueError(f'Sequence name cannot be empty (key: {key})')
    return name, idx


def dict_get(d: Mapping, key: str, default: Any = None, dtype: Any = None,
             required: bool = False) -> Any:
    """Fetch a value addressed by a dotted key from a nested mapping.

    The flat form is also accepted: if ``d`` directly contains ``key`` as a
    literal entry, that wins. Nodes holding both a leaf and a subgroup
    resolve to the leaf (``'~'``); append ``'.~'`` for the leaf explicitly
    or a trailing ``'.'`` for the subgroup. ``dtype`` optionally converts
    the result (see :func:`convert`); ``required`` raises instead of
    returning the default.
    """
    if isinstance(d, Mapping) and key in d:
        val = d[key]
        if isinstance(val, Mapping) and '~' in val:
            val = val['~']  # node holding both a leaf and a subgroup
    else:
        val = _walk(d, str(key).split('.'))
    if val is _MISSING:
        if required:
            raise RuntimeError(f'Required parameter is missing: {key}')
        return default
    return convert(val, dtype) if dtype is not None else val


def _lookup(cur: Mapping, p: str) -> Any:
    """Case/whitespace-insensitive key lookup (nesting lowercases keys;
    direct nested dicts may not be normalized)."""
    if p in cur:
        return cur[p]
    for k, v in cur.items():
        if isinstance(k, str) and k.strip().lower() == p:
            return v
    return _MISSING


def _walk(d: Any, parts: list[str]) -> Any:
    parts = [p.strip().lower() for p in parts]
    cur = d
    last = ''
    for i, p in enumerate(parts):
        last = p
        if p == '':
            continue  # trailing dot: explicitly address the subgroup
        if p == '~' and not isinstance(cur, Mapping):
            continue  # explicit leaf of a plain value is the value itself
        if not isinstance(cur, Mapping):
            return _MISSING
        hit = _lookup(cur, p)
        if hit is not _MISSING:
            cur = hit
            continue
        # bracketed index into an already-nested sequence: 'b[0]' reaches
        # element 0 of the list under 'b' (nest_dict finalizes sequences
        # into lists, so dict_get(nest_dict(d), k) must match dict_get(d, k))
        if p.endswith(']') and '[' in p:
            name, _, idx_s = p[:-1].partition('[')
            if idx_s.isdigit():
                container = _lookup(cur, name.strip())
                if isinstance(container, (list, tuple)):
                    j = int(idx_s)
                    if 0 <= j < len(container):
                        cur = container[j]
                        continue
        # allow a flat remainder, e.g. {'a': {'b.c': 1}} for key 'a.b.c'
        rest = '.'.join(parts[i:])
        hit = _lookup(cur, rest)
        if hit is not _MISSING:
            return hit
        # nest the remaining flat level once (sequences, leaf markers)
        if any('[' in q or '.' in q for q in cur if isinstance(q, str)):
            return _walk(nest_dict(cur), parts[i:])
        return _MISSING
    if isinstance(cur, Mapping) and last not in ('', '~'):
        leaf = _lookup(cur, '~')
        if leaf is not _MISSING:
            return leaf
    return cur


def dict_has(d: Mapping, key: str) -> bool:
    if isinstance(d, Mapping) and key in d:
        return True
    return _walk(d, str(key).split('.')) is not _MISSING


def dict_set(d: dict, key: str, value: Any) -> dict:
    """Set a dotted key in a nested dict, making the dicts on its way."""
    parts = split_key(key)
    cur = d
    for p in parts[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[p] = nxt
        cur = nxt
    cur[parts[-1]] = value
    return d


def nest_dict(flat: Mapping, check_sequence: bool = False) -> dict:
    """Expand a flat dict with dotted keys into a nested dict. Supports
    ``name[i]`` sequence segments (finalized into index-ordered lists) and
    the ``'~'`` leaf marker for nodes that hold both a value and a
    subgroup; key segments are stripped + lowercased.

    :param check_sequence: fail when a sequence misses indices 0..len-1
    """
    res: dict = {}
    for k, v in flat.items():
        if isinstance(v, Mapping) and not isinstance(v, _Sequence):
            v = nest_dict(v)
        parts = [p.strip().lower() for p in str(k).split('.')]
        if any(not p for p in parts):
            raise ValueError(f'Invalid key in tree dictionary: {k}')
        _nest_insert(res, parts, v, k)
    return _finalize_sequences(res, check_sequence)


def _nest_insert(res: dict, parts: list[str], value: Any, key: str) -> None:
    cur = res
    for i, part in enumerate(parts):
        name, idx = _parse_part(part, key)
        last = i == len(parts) - 1
        if idx is not None:
            node = cur.setdefault(name, _Sequence())
            if not isinstance(node, _Sequence):
                raise ValueError(
                    f'Key {key} uses {name!r} as a sequence, but it already '
                    f'holds {type(node).__name__}')
            if last:
                old = node.get(idx)
                if isinstance(old, dict):
                    # leaf joining an element's existing subgroup — same
                    # '~' merge as the plain-dict case (silently replacing
                    # would destroy the subgroup's keys)
                    old['~'] = value
                else:
                    node[idx] = value
            else:
                cur = node.setdefault(idx, {})
                if not isinstance(cur, dict):
                    node[idx] = {'~': cur}
                    cur = node[idx]
        elif last:
            old = cur.get(name)
            if isinstance(old, _Sequence):
                raise ValueError(
                    f'Key {key} assigns {name!r}, which is already a sequence')
            if isinstance(old, dict):
                old['~'] = value  # leaf joining an existing subgroup
            else:
                cur[name] = value
        else:
            nxt = cur.setdefault(name, {})
            if isinstance(nxt, _Sequence):
                raise ValueError(
                    f'Key {key} uses {name!r} as a group, but it is already '
                    f'a sequence')
            if not isinstance(nxt, dict):
                cur[name] = {'~': nxt}  # subgroup joining an existing leaf
                nxt = cur[name]
            cur = nxt


def _finalize_sequences(node: Any, check: bool):
    if isinstance(node, _Sequence):
        if check and any(i not in node for i in range(len(node))):
            raise ValueError('Sequence is missing indices')
        return [_finalize_sequences(node[i], check) for i in sorted(node)]
    if isinstance(node, dict):
        return {k: _finalize_sequences(v, check) for k, v in node.items()}
    return node


def flatten_dict(d: Mapping, prefix: str = '') -> dict:
    """The inverse of :func:`nest_dict`: a nested dict as dotted keys."""
    res: dict = {}
    for k, v in d.items():
        key = f'{prefix}{k}'
        if isinstance(v, Mapping) and v:
            res.update(flatten_dict(v, prefix=f'{key}.'))
        else:
            res[key] = v
    return res


def dict_merge(base: Mapping | None, *overlays: Mapping | None) -> dict:
    """Deep merge: later dicts override earlier ones; nested dicts merge
    recursively, everything else replaces. Inputs are not mutated."""
    res: dict = dict(base or {})
    for overlay in overlays:
        if not overlay:
            continue
        for k, v in overlay.items():
            if isinstance(v, Mapping) and isinstance(res.get(k), Mapping):
                res[k] = dict_merge(res[k], v)
            else:
                res[k] = v
    return res


def convert(value: Any, dtype: Any) -> Any:
    """Convert ``value`` to ``dtype``, understanding typing generics like
    ``List[int]`` and passing None through untouched."""
    if value is None or dtype is None:
        return value
    origin = typing.get_origin(dtype)
    if origin is dict:
        args = typing.get_args(dtype)
        tk, tv = (args + (None, None))[:2]
        return {convert(k, tk): convert(v, tv) for k, v in dict(value).items()}
    if origin in (list, tuple, set):
        args = typing.get_args(dtype)
        elem = args[0] if args else None
        items = value if isinstance(value, (list, tuple, set)) else [value]
        return origin(convert(v, elem) for v in items)
    if dtype is bool:
        if isinstance(value, str):
            return value.strip().lower() in ('1', 'true', 'yes', 'on')
        return bool(value)
    if isinstance(value, dtype) if isinstance(dtype, type) else False:
        return value
    return dtype(value)


# -- small collection helpers -------------------------------------------------

def as_list(v: Any) -> list:
    if v is None:
        return []
    if isinstance(v, (list, tuple, set, frozenset)):
        return list(v)
    if isinstance(v, Iterable) and not isinstance(v, (str, bytes, Mapping)):
        return list(v)
    return [v]


def as_set(v: Any) -> set:
    return set(as_list(v))


def as_tuple(v: Any) -> tuple:
    return tuple(as_list(v))


def unwrap_singular(v: Any, fail: bool = True) -> Any:
    """The one element of a one-element collection (a mapping's one value);
    anything that is not a collection passes through. A collection of
    another size raises ValueError, or with ``fail=False`` passes
    through."""
    if isinstance(v, Mapping):
        vals = list(v.values())
    elif isinstance(v, (str, bytes)) or not isinstance(v, Iterable):
        return v
    else:
        vals = list(v)
    if len(vals) == 1:
        return vals[0]
    if fail:
        raise ValueError('Container does not contain exactly one element.')
    return v


def default(value: Any, fallback: Any) -> Any:
    return fallback if value is None else value


def native(v: Any) -> Any:
    """numpy scalars and arrays as plain Python values (for JSON), through
    lists, tuples and dicts."""
    import numpy as np

    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (list, tuple)):
        return type(v)(native(x) for x in v)
    if isinstance(v, dict):
        return {native(k): native(x) for k, x in v.items()}
    return v


def format_array(arr, p: int = 3, sep: str = ', ') -> str:
    """A sequence as compact text: floats at ``p`` decimals without
    trailing zeros."""
    def fmt(v):
        if isinstance(v, float):
            s = f'{v:.{p}f}'.rstrip('0').rstrip('.')
            return s if s else '0'
        return str(v)
    return sep.join(fmt(v) for v in as_list(arr))


def short_message(text: str, limit: int = 120, ellipsis: str = '...') -> str:
    """``text`` cut to ``limit`` characters, the cut marked."""
    text = str(text)
    if len(text) <= limit:
        return text
    return text[:max(limit - len(ellipsis), 0)] + ellipsis


def unit_vector(v):
    import numpy as np
    arr = np.asarray(v, dtype=float)
    n = np.linalg.norm(arr)
    return arr / n if n > 0 else arr


def parse_int(v: Any, err: Any = None) -> int | None:
    try:
        return int(v)
    except (TypeError, ValueError):
        return err


def parse_float(v: Any, err: Any = None) -> float | None:
    try:
        return float(v)
    except (TypeError, ValueError):
        return err
