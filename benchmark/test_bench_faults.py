"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell of this benchmark can have: an answer altered where
it is produced (the engine's unpacked masks), and half of the batch left
out (the U-Net batch of tiles x mirrors computed for its first half, the
rest copied from it). A sound run of the same cell passes."""

import numpy as np
import pytest
import torch

from totalsegmentator2d_tpu_torch.inference import ensemble_engine

CELLS = ['ct-exact.solo', 'ct-fast.cohort8', 'ct-fast.cohort8-mixed']


def altered_answer(monkeypatch):
    unpack = ensemble_engine.unpack_bits

    def wrong(packed, n_labels):
        out = unpack(packed, n_labels).copy()
        h, w = out.shape[-3:-1]
        out[..., h // 2 - 4:h // 2 + 4, w // 2 - 4:w // 2 + 4, 0] ^= 1
        return out
    monkeypatch.setattr(ensemble_engine, 'unpack_bits', wrong)


def half_batch(monkeypatch):
    net = ensemble_engine.EnsembleEngine._net

    def half(self, batch):
        b = batch.shape[0]
        out = net(self, batch[:max(b // 2, 1)])
        return torch.cat([out] * 2, dim=1)[:, :b]
    monkeypatch.setattr(ensemble_engine.EnsembleEngine, '_net', half)


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('fault', [None, altered_answer, half_batch])
def test_fault_is_not_correct(run_small, monkeypatch, cell, fault):
    if fault is not None:
        fault(monkeypatch)
    code, line, err = run_small(cell, seed=2 ** 31 + 21)
    assert code == 0, err
    assert line['correct'] == (fault is None), line['check']
    if fault is not None:
        assert np.isfinite(line['check']['worst_flip_logit']['value'])
