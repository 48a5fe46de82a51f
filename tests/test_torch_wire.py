"""The PyTorch port's serving wires against the reference package's, on the
same seeded numpy inputs: the int16 input wire (``wire_detect``,
``_wire_pack``, ``_wire_restore``) and the compact mask wire
(``_compact_pack``, ``uncompact``, ``prefix_buckets``, ``pick_prefix``,
``occupied_count``, ``fetch_compact``, ``fetch_compact_batch``). Every
result must be bit-identical to the reference's, the compact buffer's
trash row included, and both wires must reproduce the plain wire exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from totalsegmentator2d_tpu.inference import ensemble_engine as J
from totalsegmentator2d_tpu_torch.inference import ensemble_engine as P
from totalsegmentator2d_tpu_torch.inference.program import _wire_restore


def _channels(rng, kind, shape=(23, 17)):
    """One float32 channel of a kind the wire must classify."""
    if kind == 'zero':
        return np.zeros(shape, np.float32)
    if kind == 'integral':
        return rng.integers(-1024, 3072, shape).astype(np.float32)
    if kind == 'fractional':
        return (rng.standard_normal(shape) * 100).astype(np.float32)
    if kind == 'nan':
        ch = rng.integers(-5, 5, shape).astype(np.float32)
        ch[3, 4] = np.nan
        return ch
    if kind == 'inf':
        ch = rng.integers(-5, 5, shape).astype(np.float32)
        ch[0, 0] = np.inf
        return ch
    if kind == 'out-of-range':
        ch = rng.integers(-5, 5, shape).astype(np.float32)
        ch[1, 1] = 40000.0
        return ch
    raise ValueError(kind)


KINDS = ('zero', 'integral', 'fractional', 'nan', 'inf', 'out-of-range')
LAYOUTS = [('integral', 'fractional'), ('fractional', 'integral'),
           ('integral', 'integral'), ('fractional', 'fractional'),
           ('zero', 'fractional'), ('nan', 'integral'),
           ('integral', 'fractional', 'integral'), ('out-of-range',),
           ('inf', 'zero')]


@pytest.mark.parametrize('kind', KINDS)
def test_wire_detect_matches_reference(kind):
    rng = np.random.default_rng(1)
    arr = np.stack([_channels(rng, kind), _channels(rng, 'integral')], -1)
    assert P.wire_detect(arr) == J.wire_detect(arr)
    assert P.wire_detect(arr)[1] is True
    assert P.wire_detect(arr)[0] is (kind in ('zero', 'integral'))


@pytest.mark.parametrize('layout', LAYOUTS, ids='-'.join)
def test_wire_pack_and_restore_match_reference(layout):
    rng = np.random.default_rng(2)
    arr = np.stack([_channels(rng, k) for k in layout], -1)
    wire = P.wire_detect(arr)
    pay, jpay = P._wire_pack(arr, wire), J._wire_pack(arr, wire)
    assert type(pay) is type(jpay)
    for a, b in zip(pay if isinstance(pay, tuple) else (pay,),
                    jpay if isinstance(jpay, tuple) else (jpay,)):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    tpay = (tuple(torch.from_numpy(p) for p in pay) if isinstance(pay, tuple)
            else torch.from_numpy(pay))
    restored = _wire_restore(tpay, wire).numpy()
    ref = np.asarray(J._wire_restore(jpay, wire, jnp.float32))
    assert restored.dtype == np.float32
    np.testing.assert_array_equal(restored, ref)
    # the wire is lossless: bit-identical to the float32 input
    np.testing.assert_array_equal(restored, arr)


def test_wire_restore_keeps_a_leading_batch_axis():
    rng = np.random.default_rng(3)
    arr = np.stack([np.stack([_channels(rng, 'fractional'),
                              _channels(rng, 'integral')], -1)
                    for _ in range(3)])
    wire = (False, True)
    pay = P._wire_pack(arr, wire)
    assert pay[0].shape == (3, 23, 17, 1) and pay[0].dtype == np.int16
    restored = _wire_restore(tuple(torch.from_numpy(p) for p in pay), wire)
    np.testing.assert_array_equal(restored.numpy(), arr)


def _packed(rng, density, shape=(37, 29, 3)):
    return ((rng.random(shape) < density)
            * rng.integers(1, 256, shape)).astype(np.uint8)


DENSITIES = (0.0, 0.02, 0.3, 1.0)


@pytest.mark.parametrize('density', DENSITIES)
@pytest.mark.parametrize('shape', [(37, 29, 3), (16, 16, 2), (5, 3, 15)])
def test_compact_pack_matches_reference(density, shape):
    rng = np.random.default_rng(4)
    packed = _packed(rng, density, shape)
    buf, occ = P._compact_pack(torch.from_numpy(packed))
    jbuf, jocc = jax.jit(J._compact_pack)(packed)
    buf, occ = buf.numpy(), occ.numpy()
    assert buf.dtype == np.uint8 and occ.dtype == np.uint8
    np.testing.assert_array_equal(buf, np.asarray(jbuf))
    np.testing.assert_array_equal(occ, np.asarray(jocc))
    T = -(-packed.size // P._COMPACT_TILE)
    assert buf.shape == (T + 1, P._COMPACT_TILE)
    count = P.occupied_count(occ, T)
    assert count == J.occupied_count(np.asarray(jocc), T)
    # the prefix holds the occupied tiles; every later row, the trash row
    # T included, is zero
    assert not buf[count:].any()
    np.testing.assert_array_equal(
        P.uncompact(buf[:P.pick_prefix(count, T)], occ, count, shape), packed)
    np.testing.assert_array_equal(
        P.uncompact(buf, occ, count, shape),
        J.uncompact(np.asarray(jbuf), np.asarray(jocc), count, shape))


def test_compact_pack_batched_matches_reference():
    rng = np.random.default_rng(5)
    packed = np.stack([_packed(rng, d) for d in (0.0, 1.0, 0.02, 0.3)])
    buf, occ = P._compact_pack(torch.from_numpy(packed))
    jbuf, jocc = jax.jit(jax.vmap(J._compact_pack))(packed)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert not buf[:, -1].any()  # every scan's trash row


@pytest.mark.parametrize('T', [1, 2, 7, 15, 16, 17, 100, 1001, 86017])
def test_prefix_buckets_and_pick_match_reference(T):
    assert P.prefix_buckets(T) == J.prefix_buckets(T)
    for count in sorted({0, 1, T // 3, T // 2, T - 1, T} - {-1}):
        assert P.pick_prefix(count, T) == J.pick_prefix(count, T)
        assert P.pick_prefix(count, T) >= count


def test_speculative_hint_paths():
    # a program's repeated fetches keep a per-path hint (solo 'hint_solo',
    # batched 'hint_batch'); the second fetch on pulls the last bucket
    # beside the bitmap. Cover, undershoot (the bucket refetched) and
    # overshoot (extra rows ignored) all stay bit-identical.
    rng = np.random.default_rng(6)
    h, w, nb = 37, 29, 3
    T = -(-h * w * nb // 8)
    cmeta = {'T': T, 'shape': (h, w, nb)}
    for density in (0.02, 0.02, 0.9, 0.02, 0.0):
        packed = _packed(rng, density)
        rebuilt = P.fetch_compact(P._compact_pack(torch.from_numpy(packed)),
                                  cmeta)
        np.testing.assert_array_equal(rebuilt, packed)
        assert cmeta['hint_solo'] >= 1
    cmeta_b = {'T': T, 'shape': (h, w, nb)}
    for densities in ([0.02, 0.0], [0.9, 0.02], [0.0, 0.0]):
        packed = np.stack([_packed(rng, d) for d in densities])
        rebuilt = P.fetch_compact_batch(
            P._compact_pack(torch.from_numpy(packed)), cmeta_b)
        np.testing.assert_array_equal(rebuilt, packed)
        assert cmeta_b['hint_batch'] >= 1


def test_speculative_hint_solo_batch_isolation():
    # solo and batched fetches of one program share its meta dict but keep
    # separate hint slots, and stay bit-identical interleaved
    rng = np.random.default_rng(7)
    h, w, nb = 31, 27, 2
    cmeta = {'T': -(-h * w * nb // 8), 'shape': (h, w, nb)}
    for solo_d, batch_ds in ((0.02, [0.6, 0.02]), (0.02, [0.9, 0.0]),
                             (0.5, [0.02, 0.02])):
        solo = _packed(rng, solo_d, (h, w, nb))
        np.testing.assert_array_equal(
            P.fetch_compact(P._compact_pack(torch.from_numpy(solo)), cmeta),
            solo)
        batch = np.stack([_packed(rng, d, (h, w, nb)) for d in batch_ds])
        np.testing.assert_array_equal(
            P.fetch_compact_batch(P._compact_pack(torch.from_numpy(batch)),
                                  cmeta), batch)
    assert cmeta['hint_solo'] >= 1 and cmeta['hint_batch'] >= 1


def test_speculative_hint_concurrent_fetches():
    # concurrent fetches share the mutable hint; every interleaving stays
    # bit-identical
    from concurrent.futures import ThreadPoolExecutor
    rng = np.random.default_rng(8)
    h, w, nb = 23, 19, 2
    cmeta = {'T': -(-h * w * nb // 8), 'shape': (h, w, nb)}
    packs = []
    for density in (0.02, 0.6, 0.0, 0.9, 0.1, 0.02, 1.0, 0.3):
        packed = _packed(rng, density, (h, w, nb))
        packs.append((packed, P._compact_pack(torch.from_numpy(packed))))
    with ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(lambda p: P.fetch_compact(p[1], cmeta), packs))
    for (packed, _), rebuilt in zip(packs, outs):
        np.testing.assert_array_equal(rebuilt, packed)


@pytest.mark.parametrize('rows,streams', [(8, 4), (600, 4), (3, 4), (8, 1)])
def test_fetch_split_is_bit_identical(rows, streams):
    rng = np.random.default_rng(9)
    arr = rng.integers(0, 255, (rows, 40_001), dtype=np.uint8)
    out = P.fetch_split(torch.from_numpy(arr), min_bytes=1000,
                        streams=streams)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, arr)
