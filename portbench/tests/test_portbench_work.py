"""The frozen arithmetic against hand counts: the paper models' sizes and
FLOPs (Sec. IV-A2), a round's FLOPs, the kernels' bytes, the peaks."""
import json
import math

import pytest


import tiny  # noqa: F401  (the checkout and src on the path)
from portbench.harness import cells
from portbench.work import kernels, models, peaks


def _cfg(name):
    return json.loads((cells.BENCH / "configs" / f"{name}.json").read_text())


def _params(cfg):
    """The parameters of the configuration's reference module's leaves."""
    ref = cells.load_module(cells.BENCH / "configs" / cfg["reference"])
    return sum(math.prod(s) for s in ref.shapes(cfg).values())


def test_paper_cnn_counts():
    cfg = _cfg("paper-cnn")
    # conv1 28*28*128*25*1, conv2 14*14*256*25*128, fc 12544*10 MACs
    macs = 28 * 28 * 128 * 25 + 14 * 14 * 256 * 25 * 128 + 7 * 7 * 256 * 10
    assert models.forward_flops(cfg) == 2 * macs == 326_394_880
    assert _params(cfg) == 948_234 == cfg["params"]
    assert cfg["forward_flops_per_example"] == 2 * macs


def test_paper_mlp_counts():
    cfg = _cfg("paper-mlp")
    assert models.forward_flops(cfg) == 2 * (784 * 200 + 200 * 10) == 317_600
    assert _params(cfg) == 159_010 == cfg["params"]
    assert cfg["forward_flops_per_example"] == 317_600


@pytest.mark.parametrize("config,users,train_tflop",
                         [("paper-cnn", 10, 5.6404),
                          ("paper-mlp", 2000, 1.0977)])
def test_round_flops(config, users, train_tflop):
    c = cells.load_cell("cnn-paper-u10")
    f = models.round_flops(_cfg(config),
                           {**c.traffic, **c.spec, "users": users})
    assert f["local_steps"] == 18          # 600 // 32
    assert f["train"] / 1e12 == pytest.approx(train_tflop, rel=1e-4)
    assert f["eval"] == 1000 * models.forward_flops(_cfg(config))


def test_kernel_bytes():
    # the MLP stack at 2000 users: 1.27 GB, read twice and written once
    assert kernels.fused_sgd_bytes(2000, 159_010) == 3 * 2000 * 159_010 * 4
    assert kernels.delta_norm_bytes(2000, 159_010, 4) == \
        2001 * 159_010 * 4 + 4 * 4 * 2001
    assert kernels.combine_bytes(64, 156_800) == 65 * 156_800 * 4


def test_peaks_are_the_data_sheet_values():
    assert peaks.PEAK_FLOPS_F32 == 67e12
    assert peaks.PEAK_FLOPS_BF16 == 989e12
    assert peaks.HBM_BW == 3.35e12
    # a configuration's compute dtype picks its peak
    assert peaks.peak_flops("float32") == 67e12
    assert peaks.peak_flops("bfloat16") == 989e12
    with pytest.raises(ValueError):
        peaks.peak_flops("float32", tf32=True)
    assert (peaks.ITEM_BYTES["float32"], peaks.ITEM_BYTES["bfloat16"]) \
        == (4, 2)


@pytest.mark.parametrize("name", ["paper-cnn", "paper-mlp"])
def test_reference_model_shapes_match_the_counts(name):
    c = _cfg(name)
    mod = cells.load_module(cells.BENCH / "configs" / c["reference"])
    n = 0
    for shape in mod.shapes(c).values():
        k = 1
        for d in shape:
            k *= d
        n += k
    assert n == c["params"]
