"""A fused ``TS2D.predict``'s masks against the numpy chain that assembled
them before the native pass: ``unpack_bits`` of the scan's packed masks,
``ScanEngine._place`` into the full frame, each model's
``np.ascontiguousarray`` of its channels, and ``restore_dimension``'s
reshape of a projected CT's. The ``Result``'s mask arrays must equal the
chain's (values, dtype, shape), be C-contiguous, and share memory with no
other mask array of the ``Result``; and the ``Result`` must equal the one
the numpy fallback (no native pass) assembles, images' geometry and
metadata included."""

import itertools

import numpy as np

from totalsegmentator2d_tpu_torch.inference import ensemble_engine
from totalsegmentator2d_tpu_torch.inference.ensemble_engine import unpack_bits
from totalsegmentator2d_tpu_torch.inference.program import ScanEngine


def _predict_recording(tool, image, monkeypatch, **kw):
    """``tool.predict(image, **kw)`` and the (packed, bbox, full) its
    finish read."""
    engine = tool._fused
    seen = []
    wait = engine._wait_packed

    def spy(handle):
        got = wait(handle)
        seen.append(got)
        return got
    monkeypatch.setattr(engine, '_wait_packed', spy)
    try:
        res = tool.predict(image, **kw)
    finally:
        monkeypatch.setattr(engine, '_wait_packed', wait)
    assert len(seen) == 1
    return res, seen[0]


def _masks(res, ids):
    """The Result's mask images: the merged one (None without merge), then
    each model's in ``ids`` order."""
    return [res.get_segmentation()] + [res.get_segmentation(i) for i in ids]


def check_result_against_chain(tool, image, monkeypatch, **kw):
    """Predict ``image`` with the native pass and with numpy's fallback,
    and hold both Results to the numpy chain; returns the native Result."""
    res, (packed, bbox, full) = _predict_recording(tool, image, monkeypatch,
                                                   **kw)
    engine = tool._fused
    ids = list(tool.models)
    merged2d = ScanEngine._place(engine, unpack_bits(
        packed, engine.total_labels), bbox, full)
    ends = np.cumsum([0] + engine.output_label_counts)
    want = [merged2d] + [np.ascontiguousarray(merged2d[..., a:b])
                         for a, b in zip(ends[:-1], ends[1:])]
    got = _masks(res, ids)
    if not kw.get('merge', True):
        assert got[0] is None and 'segmentation' not in res.data
        got, want = got[1:], want[1:]
    arrays = [img.array for img in got]
    for a, b in zip(arrays, want):
        assert a.dtype == b.dtype == np.uint8
        assert a.size == b.size and a.shape[-1] == b.shape[-1]
        np.testing.assert_array_equal(a, np.reshape(b, a.shape))
        assert a.flags.c_contiguous
    for a, b in itertools.combinations(arrays, 2):
        assert not np.shares_memory(a, b)

    native = ensemble_engine.assemble_masks
    monkeypatch.setattr(ensemble_engine, 'assemble_masks',
                        lambda *args, **kws: None)
    try:
        fallback = tool.predict(image, **kw)
    finally:
        monkeypatch.setattr(ensemble_engine, 'assemble_masks', native)
    pairs = [(a, b) for a, b in zip(_masks(res, ids), _masks(fallback, ids))
             if a is not None or b is not None]
    for a, b in pairs:
        assert a.array.dtype == b.array.dtype and a.array.shape == b.array.shape
        np.testing.assert_array_equal(a.array, b.array)
        assert b.array.flags.c_contiguous
        assert (a.spacing, a.origin, a.is_vector, a.meta) == \
            (b.spacing, b.origin, b.is_vector, b.meta)
        np.testing.assert_array_equal(a.direction, b.direction)
    for (_, a), (_, b) in itertools.combinations(pairs, 2):
        assert not np.shares_memory(a.array, b.array)
    return res
