"""The numpy spine of the port is a COPY of the reference's, and stays
one: each copied file must equal its original after the package rename,
up to the hunks listed here. Also: the port imports neither ``jax`` nor
``repro``, and its entry points refuse to run on the CPU unless asked.
"""
import difflib
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

#: files copied with ``repro.`` -> ``repro_torch.`` and nothing else,
#: except the inline lint suppressions and the hunks in ALLOWED_HUNKS
SPINE = [
    "core/rngs.py", "core/counter.py", "core/csma.py",
    "data/partition.py", "data/synthetic.py", "data/__init__.py",
    "engine/registry.py", "engine/strategies.py", "engine/types.py",
    "engine/spec.py", "channel/spec.py", "channel/model.py",
    "faults/spec.py", "faults/injectors.py",
    "objectives/spec.py", "objectives/server.py",
    "checkpoint/fl_state.py",
    "configs/base.py", "configs/registry.py", "configs/yi_9b.py",
    "configs/gemma2_27b.py", "configs/whisper_small.py",
    "configs/deepseek_v3_671b.py", "configs/phi3_mini_3_8b.py",
    "configs/mamba2_370m.py", "configs/hymba_1_5b.py",
    "configs/kimi_k2_1t.py", "configs/phi3_vision_4_2b.py",
    "configs/phi4_mini_3_8b.py",
]

#: The reprolint whitelist for rng construction matches the reference's
#: paths only; the copies carry an inline suppression on each
#: constructor line instead.
SUPPRESSION = re.compile(
    r"  # reprolint: disable=RL101 # copy of a whitelisted site$")
SUPPRESSED_LINES = {"core/rngs.py": 14, "core/csma.py": 2,
                    "data/synthetic.py": 2, "data/partition.py": 2}

#: The reference's comments date some designs by the number of the
#: change that brought them; the port's files stand alone, so the copy
#: drops those tags. The same substitutions, applied to the original,
#: must give the copy's line; file -> how many lines they touch.
HISTORY_TAGS = [(re.compile(p), r) for p, r in (
    (r" \(PR \d+\)", ""), (r"PR \d+, ", ""), (r" PR-\d+", ""),
    (r"through PR \d+$", "at first"), (r"PR \d+ ", ""))]
UNTAGGED_LINES = {"core/rngs.py": 5, "data/synthetic.py": 1,
                  "engine/types.py": 2, "faults/spec.py": 2}

#: file -> list of (lines removed from the original, lines added)
ALLOWED_HUNKS = {
    # the device contention loop runs on a torch device, which the
    # simulator is given (the engine hands it the backend's)
    "core/csma.py": [
        (["                 seed: int = 0, backend: str = \"numpy\"):"],
         ["                 seed: int = 0, backend: str = \"numpy\", "
          "device=None):"]),
        ([], ["        self.device = device    # device backend: where the "
              "loop runs"]),
        (["                max_sim_slots=cfg.max_sim_slots)"],
         ["                max_sim_slots=cfg.max_sim_slots, "
          "device=self.device)"])],
    # the stale buffer's checkpoint form: tensors to numpy, not
    # jax.device_get
    "faults/injectors.py": [
        (["        import jax"],
         ["        from repro_torch.convert import params_to_numpy"]),
        (["            \"stale\": [(u, jax.device_get(p), n)"],
         ["            \"stale\": [(u, params_to_numpy(p), n)"])],
    # activation_dtype is a torch dtype, not a jnp one
    "configs/base.py": [
        (["import jax.numpy as jnp"], ["import torch"]),
        (["        return jnp.dtype(self.dtype)"],
         ["        return getattr(torch, self.dtype)"])],
    # lane_params slices tensors of a nested dict, not a jax pytree
    "engine/types.py": [(
        ["        import jax",
         "        return jax.tree.map(lambda p: p[e], self.final_globals)"],
        ["        from repro_torch.tree import tree_map",
         "        return tree_map(lambda p: p[e], self.final_globals)"])],
}


def _untag(line):
    for pat, repl in HISTORY_TAGS:
        line = pat.sub(repl, line)
    return line


def _renamed_original(rel):
    """The original's lines after the package rename and without the
    history tags, and the number of lines the latter touched."""
    text = (SRC / "repro" / rel).read_text()
    lines = re.sub(r"\brepro\.", "repro_torch.", text).splitlines()
    clean = [_untag(l) for l in lines]
    return clean, sum(a != b for a, b in zip(lines, clean))


def _hunks(a, b):
    out = []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, a, b, autojunk=False).get_opcodes():
        if tag != "equal":
            out.append((a[i1:i2], b[j1:j2]))
    return out


@pytest.mark.parametrize("rel", SPINE)
def test_spine_file_is_the_renamed_original(rel):
    port = (SRC / "repro_torch" / rel).read_text().splitlines()
    n_suppressed = sum(bool(SUPPRESSION.search(l)) for l in port)
    assert n_suppressed == SUPPRESSED_LINES.get(rel, 0)
    port = [SUPPRESSION.sub("", l) for l in port]
    original, n_untagged = _renamed_original(rel)
    assert n_untagged == UNTAGGED_LINES.get(rel, 0)
    assert _hunks(original, port) == ALLOWED_HUNKS.get(rel, []), (
        f"{rel} drifted from src/repro/{rel}:\n" + "\n".join(
            difflib.unified_diff(original, port, lineterm="", n=0)))


def test_every_suppression_sits_on_an_rng_constructor_line():
    for rel in SUPPRESSED_LINES:
        for line in (SRC / "repro_torch" / rel).read_text().splitlines():
            if SUPPRESSION.search(line):
                assert re.search(r"np\.random\.(default_rng|SeedSequence)\(",
                                 line), line


def test_objective_descriptors_match_the_reference():
    """The registrations in ``objectives/local.py`` must describe the
    reference's objectives."""
    from repro.objectives import spec as jspec
    from repro_torch.objectives import spec as tspec
    jspec._ensure_registered()
    tspec._ensure_registered()
    assert sorted(tspec.LOCAL_OBJECTIVES) == sorted(jspec.LOCAL_OBJECTIVES)
    probe_j = jspec.ObjectiveSpec(mu=0.25, alpha=0.5)
    probe_t = tspec.ObjectiveSpec(mu=0.25, alpha=0.5)
    for name, d in tspec.LOCAL_OBJECTIVES.items():
        ref = jspec.LOCAL_OBJECTIVES[name]
        assert d.uses_h == ref.uses_h
        assert d.coeff(probe_t) == ref.coeff(probe_j)
    assert {n: (d.kind, d.uses_state)
            for n, d in tspec.SERVER_AGGREGATORS.items()} == \
        {n: (d.kind, d.uses_state)
         for n, d in jspec.SERVER_AGGREGATORS.items()}


PORT_MODULES = ["repro_torch.engine", "repro_torch.core",
                "repro_torch.launch.train", "repro_torch.launch.serve",
                "repro_torch.launch.steps", "repro_torch.models.model",
                "repro_torch.configs.registry", "repro_torch.convert",
                "repro_torch.kernels.ops", "repro_torch.kernels.build",
                "repro_torch.models.paper_models", "repro_torch.optim",
                "repro_torch.data", "repro_torch.objectives",
                "repro_torch.channel", "repro_torch.faults"]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import repro_torch.engine, repro_torch.core\n"   # engine FIRST
        + "".join(f"import {m}\n" for m in PORT_MODULES) +
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=SRC.parent,
                          env={"PYTHONPATH": str(SRC), "PATH": ""},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "clean"


def test_no_source_line_of_the_port_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import|from) (jax|repro)(\.|\s|$)")
    files = list((SRC / "repro_torch").rglob("*.py")) \
        + [SRC.parent / "chip_smoke.py"]
    assert len(files) > 30
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            assert not pat.search(line), f"{f}:{i}: {line}"


def test_port_mirrors_the_reference_layout():
    """Every python module of the port sits at the path of its
    counterpart, apart from the files that have none (``token_sum.py``
    binds the LLM step's fixed-order sum, which the reference leaves to
    XLA)."""
    own = {"device.py", "tree.py", "convert.py", "kernels/build.py",
           "kernels/token_sum.py"}
    for f in (SRC / "repro_torch").rglob("*.py"):
        rel = f.relative_to(SRC / "repro_torch").as_posix()
        if rel in own or rel.endswith("__init__.py"):
            continue
        assert (SRC / "repro" / rel).is_file(), rel


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")


def _tiny():
    import numpy as np
    data = [{"x": np.zeros((8, 4), np.float32),
             "y": np.zeros(8, np.int64)} for _ in range(3)]
    params = {"w": torch.zeros(4, 2)}

    def loss_fn(p, b):
        return (b["x"] @ p["w"]).sum()
    return data, params, loss_fn


def test_host_backend_default_device_needs_cuda():
    _no_cuda()
    from repro_torch.engine import HostBackend
    data, _, loss_fn = _tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HostBackend(loss_fn, data, batch_size=4)
    assert HostBackend(loss_fn, data, batch_size=4,
                       device="cpu").device.type == "cpu"


def test_build_host_engine_default_device_needs_cuda():
    _no_cuda()
    from repro_torch.engine import ExperimentSpec, build_host_engine
    data, params, loss_fn = _tiny()
    spec = ExperimentSpec(rounds=1, batch_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_host_engine(spec, params, loss_fn, data)
    build_host_engine(spec, params, loss_fn, data, device="cpu")


def test_launch_train_default_device_needs_cuda():
    _no_cuda()
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--rounds", "1", "--n-train", "100", "--n-test", "20"])
    assert train.make_parser().parse_args([]).device == "cuda"


def test_launch_serve_default_device_needs_cuda():
    _no_cuda()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--batch", "1", "--prompt-len", "2", "--gen-len", "2"])
    assert serve.make_parser().parse_args([]).device == "cuda"


def test_build_llm_engine_default_device_needs_cuda():
    _no_cuda()
    from repro_torch.launch import train
    args = train.make_parser().parse_args(
        ["--arch", "yi-9b", "--users", "2", "--llm-seq", "4",
         "--llm-seqs-per-user", "2", "--batch-size", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.build_llm_engine(args)
    args.device = "cpu"
    assert train.build_llm_engine(args).backend.device.type == "cpu"


def test_accuracy_eval_default_device_needs_cuda():
    _no_cuda()
    import numpy as np
    from repro_torch.engine import make_accuracy_eval
    x, y = np.zeros((4, 3), np.float32), np.array([0, 1, 0, 1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_accuracy_eval(lambda p, x: x[:, :2], x, y)
    ev = make_accuracy_eval(lambda p, x: x[:, :2] + p, x, y, batch=3,
                            device="cpu")
    assert ev(torch.tensor([1.0, 0.0])) == 0.5


def test_kernel_build_fails_loudly_without_a_compiler(monkeypatch, tmp_path):
    """No nvcc: the build raises; nothing falls back to a plain version."""
    from repro_torch.kernels import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    assert set(build.SIGNATURES) == {p.stem for p in build.CSRC.glob("*.cu")}
    with pytest.raises(TypeError):
        build.dtype_code(torch.float16)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        build.check_launch(9, "x")


def test_engine_exports_the_reference_names():
    """``repro_torch.engine.__all__`` holds every name of the reference's
    ``__all__`` but ``SiloBackend`` (the cross-silo path, not ported
    yet), and each name imports; compared as names only."""
    import repro.engine as jeng
    import repro_torch.engine as teng
    missing = set(jeng.__all__) - set(teng.__all__)
    assert missing == {"SiloBackend"}, missing
    for name in teng.__all__:
        assert hasattr(teng, name), name
    from repro_torch.engine import SweepState, SweepTrainResult  # noqa: F401
