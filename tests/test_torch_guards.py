"""The port's guards and paper-path examples, on the CPU:
``tools/check_winner_pins_torch.py`` (the pin scenario of
``tools/check_winner_pins.py`` and its twin lanes, through the port)
must reproduce ``tests/winner_pins.json`` lane for lane, every twin's
globals bit-equal to its plain lane's; ``examples/quickstart_torch.py``
and ``examples/fl_noniid_fashion_torch.py`` run a few rounds with
``--device cpu``.
"""
import importlib.util
import json
import os

REPO = os.path.join(os.path.dirname(__file__), "..")


def _load(*parts):
    path = os.path.join(REPO, *parts)
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(parts[-1])[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_winner_pins_tool_reproduces_the_pins_on_the_cpu(capsys):
    tool = _load("tools", "check_winner_pins_torch.py")
    assert tool.main(["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.splitlines()[0])
    with open(os.path.join(REPO, "tests", "winner_pins.json")) as f:
        pins = json.load(f)
    assert res["ok"] and res["lanes"] == len(pins["winners"]) == 50
    assert res["winners_differ"] == [] and res["twins_not_bit_equal"] == []


def test_winner_pins_tool_names_a_lane_that_leaves_the_pins(monkeypatch):
    """A lane whose winners differ is named, and the run fails."""
    tool = _load("tools", "check_winner_pins_torch.py")
    real = tool.scenario_winners

    def shifted(device):
        winners, unequal = real(device)
        winners["random-distributed/seed1/sparse"] = [[0]] * 4
        return winners, unequal
    monkeypatch.setattr(tool, "scenario_winners", shifted)
    res = tool.check("cpu")
    assert not res["ok"]
    assert res["winners_differ"] == ["random-distributed/seed1/sparse"]


def test_quickstart_twin_runs_on_the_cpu(capsys):
    _load("examples", "quickstart_torch.py").main(
        ["--device", "cpu", "--rounds", "4"])
    out = capsys.readouterr().out
    assert "== random-distributed ==" in out
    assert "== priority-distributed ==" in out
    assert out.count("selections per user:") == 2


def test_fl_noniid_fashion_twin_runs_on_the_cpu(tmp_path):
    res = _load("examples", "fl_noniid_fashion_torch.py").main(
        ["--device", "cpu", "--rounds", "4", "--n-train", "1200",
         "--out", str(tmp_path)])
    assert len(res) == 5 and "priority-centralized/no-counter" in res
    assert all(r["acc"] and sum(r["selections"]) > 0
               for r in res.values())
    with open(tmp_path / "noniid_fashion_mlp.json") as f:
        assert json.load(f) == json.loads(json.dumps(res))
