"""The ``lm`` kind on its CPU test cell (``tiny.lm_cell``, loaded from
``tests/lm/`` as a cell of the benchmark is): a whole run comes out
``correct``, and not correct with half of each batch left out or one
winner's update dropped from the merge; the reference never holds more
than one user's model; a bf16 variant records and reads with the bf16
peak and 2 bytes a parameter, and its reference holds bf16 weights; the FLOP count is a hand count; families the kind
cannot reference are refused."""
import json
import weakref

import numpy as np
import pytest

import tiny
from portbench.harness import bench, cells, traffic
from portbench.harness.program import Timing
from portbench.reference import fl

SEED = 2 ** 31 + 77


def _half_batch(engine):
    from repro_torch.core.client import sgd_epoch_scan
    be = engine.backend
    loss = be._loss_fn

    def half(params, batch):
        return loss(params, {k: v[: v.shape[0] // 2]
                             for k, v in batch.items()})
    be._epoch_run = sgd_epoch_scan(half, be._lr)


def _winner_dropped(engine):
    """The merge leaves the second winner's model out (its weight goes to
    the first)."""
    be = engine.backend
    merge = be._fused_merge

    def dropped(trained, idx, w, old):
        w = w.clone()
        w[0], w[1] = w[0] + w[1], 0.0
        return merge(trained, idx, w, old)
    be._fused_merge = dropped


def test_the_lm_cell_is_correct():
    res = tiny.run(tiny.lm_cell(), seed=SEED, seconds=0.0)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["checks"]["winners_mismatch"]["value"] == 0


@pytest.mark.parametrize("fault", [_half_batch, _winner_dropped])
def test_a_broken_lm_path_is_not_correct(fault):
    res = tiny.run(tiny.lm_cell(), seed=SEED, seconds=0.0, patch=fault)
    assert res["correct"] is False and res["failed"] >= 1
    assert list(res)[-1] == "checks"


def test_the_reference_holds_one_users_model_at_a_time():
    c = tiny.lm_cell()
    step = c.model.losses_and_grads
    seen, most = [], []

    def counting(stack, batch, ops, cfg):
        leaf = stack["head.w_out"]
        assert leaf.shape[0] == 1
        # models trained before this call that are still alive
        most.append(sum(r() is not None and r() is not leaf for r in seen))
        seen.append(weakref.ref(leaf))
        return step(stack, batch, ops, cfg)
    c.model.losses_and_grads = counting
    with tiny.one_thread():
        inputs = traffic.make_inputs(c, SEED, "cpu")
        fl.Reference(c, inputs, SEED, "cpu").run(1)
    users, steps = c.traffic["users"], 2
    assert len(most) == users * steps
    assert max(most) == 0


def _bf16_cell():
    c = tiny.lm_cell()
    c.config["dtype"] = c.config["param_dtype"] = "bfloat16"
    return c


def test_a_bf16_variant_records_and_reads():
    c = _bf16_cell()
    res = tiny.run(c, seed=SEED, seconds=0.0)
    assert all(np.isfinite(v["value"]) for v in res["checks"].values())
    with tiny.one_thread():
        inputs = traffic.make_inputs(c, SEED, "cpu")
    assert all(v.dtype == tiny.torch.bfloat16 for v in inputs.init.values())
    assert all(v.dtype == np.float32 for v in inputs.init_host.values())
    for k, v in inputs.init.items():
        np.testing.assert_array_equal(v.float().numpy(), inputs.init_host[k])
    timing = Timing(window_rounds=10, window_s=2.0, profile={
        "busy_s": 1.0, "gaps": {},
        "ops": {"sgd_leaves_kernel": [0.5, 20], "delta_norm_kernel": [0.1, 10]}})
    r = bench.Reading(c, timing)
    assert (r.peak_flops, r.param_bytes) == (989e12, 2)
    f = r.round_flops
    read = {m: cells.load_module(cells.reader_path(m)).read(r)
            for m in ("mfu", "fused_sgd_roofline", "delta_norm_roofline")}
    assert read["mfu"] == pytest.approx(
        100 * (f["train"] + f["eval"]) * 10 / 2.0 / 989e12)
    assert read["fused_sgd_roofline"] == pytest.approx(
        100 * 20 * 3 * 4 * r.params * 2 / 3.35e12 / 0.5)
    assert read["delta_norm_roofline"] == pytest.approx(
        100 * 10 * (5 * r.params * 2 + 4 * r.leaves * 5) / 3.35e12 / 0.1)


def test_a_bf16_reference_holds_bf16_weights(monkeypatch):
    """Every step's trained weights and every merged global hold bf16
    values, and the f32 reference's do not."""
    seen = []
    norms = fl.leaf_norms

    def keeping(model, glob):
        seen.append({k: v.detach().clone() for k, v in model.items()})
        return norms(model, glob)
    monkeypatch.setattr(fl, "leaf_norms", keeping)
    for c, held in ((_bf16_cell(), True), (tiny.lm_cell(), False)):
        seen.clear()
        with tiny.one_thread():
            inputs = traffic.make_inputs(c, SEED, "cpu")
            fl.Reference(c, inputs, SEED, "cpu").run(2)
        # per round, the users' trained models, then the merged global
        assert len(seen) == 2 * (c.traffic["users"] + 1)
        for m in seen:
            bf = all(np.array_equal(v.numpy(),
                                    v.to(tiny.torch.bfloat16).float().numpy())
                     for v in m.values())
            assert bf is held


def test_the_flop_count_is_a_hand_count():
    c = tiny.lm_cell()
    # per layer: q, k, v, o 4 x 256 x 256 MACs, the MLP 3 x 256 x 512, the
    # scores and weighted sum 2 x 4 heads x 64 x 16.5 keys on average;
    # the head 256 x 512
    layer = 2 * (4 * 256 * 256 + 3 * 256 * 512) + 2 * 2 * 4 * 64 * 33 // 2
    per_token = 2 * layer + 2 * 256 * 512
    assert c.model.forward_flops_per_token(c.config, 32) == per_token \
        == 2_917_376
    f = bench.Reading(c, Timing()).round_flops
    # 4 users x 2 steps x 4 sequences x 32 tokens, 4 test sequences
    assert f == {"train": 3 * per_token * 4 * 2 * 4 * 32,
                 "eval": per_token * 4 * 32, "local_steps": 2}
    assert bench.Reading(c, Timing()).params == (
        2 * 512 * 256 + 256 + 2 * (2 * 256 + 4 * 256 * 256
                                   + 3 * 256 * 512))


@pytest.mark.parametrize("arch,family", [("mamba2-370m", "ssm"),
                                         ("hymba-1.5b", "hybrid"),
                                         ("whisper-small", "audio")])
def test_families_without_a_reference_are_refused(tmp_path, arch, family):
    root = tiny.Path(__file__).parent / "lm"
    for d in ("configs", "workloads"):
        (tmp_path / d).mkdir()
    cfg = json.loads((root / "configs" / "yi-9b-tiny.json").read_text())
    cfg.update(arch=arch, reference=str(root.parents[1] / "reference"
                                        / "lm.py"))
    cfg["widths"]["family"] = family
    (tmp_path / "configs" / "yi-9b-tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "workloads" / "lm-tiny.json").write_text(
        (root / "workloads" / "lm-tiny.json").read_text())
    with pytest.raises(ValueError, match="family"):
        cells.load_cell("lm-tiny", root=tmp_path)
