"""A whole run of a cell (its set-up and window on the CPU, at a small
size; the harness's look for a card skipped) with the timed path broken
underneath comes out ``correct: false``, once for each fault the cells
can have:

* a round that returns its state unchanged (the merge keeps the old
  global);
* half of each batch left out of the local step, the mean taken over the
  rest;
* an answer altered where it is produced: the winners' delivery order,
  and a priority (one user's, by a tenth);

and a sound run comes out ``correct: true``; also with the paper's MLP
under device CSMA (``tiny.mlp_cell``). The cells run on one chip,
so there is no exchange between chips to leave out.
"""
import pytest
import torch

import tiny


def _unchanged(engine):
    engine.backend._fused_merge = lambda trained, idx, w, old: old


def _half_batch(engine):
    from repro_torch.core.client import sgd_epoch_scan
    be = engine.backend
    loss = be._loss_fn

    def half(params, batch):
        return loss(params, {k: v[: v.shape[0] // 2]
                             for k, v in batch.items()})
    be._epoch_run = sgd_epoch_scan(half, be._lr)


def _winners_reordered(engine):
    select = engine._select_lanes

    def reordered(*a):
        winners_all, sels = select(*a)
        return [list(reversed(w)) for w in winners_all], sels
    engine._select_lanes = reordered


def _priority_altered(engine):
    be = engine.backend
    prios = be._sweep_priorities

    def altered(trained, globs):
        p = prios(trained, globs)
        return torch.cat([p[:, :1] * 1.1, p[:, 1:]], dim=1)
    be._sweep_priorities = altered


def _small(name):
    if name == "paper-mlp":
        return tiny.mlp_cell(users=8, k=3)
    return tiny.cell(name, users=8, k=3)


@pytest.mark.parametrize("name", ["cnn-paper-u10", "paper-mlp"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch,
                                   _winners_reordered, _priority_altered])
def test_a_broken_path_is_not_correct(name, fault):
    res = tiny.run(_small(name), patch=fault)
    assert res["correct"] is False
    assert res["failed"] >= 1
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", ["cnn-paper-u10", "paper-mlp"])
def test_the_sound_path_is_correct(name):
    res = tiny.run(_small(name))
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["winners_mismatch"]["value"] == 0
