"""The CNN cell is what it was before the harness took kinds: its inputs
are the same bits for a seed (a digest taken on the parent commit's
harness), and the change gaps read from the records' change norms equal
the gaps of the whole merged globals that the records used to keep."""
import hashlib

import numpy as np

import tiny
from portbench.harness import program, traffic
from portbench.reference import fl, judge

SEED = 2 ** 31 + 4242
#: sha256 of ``cnn-paper-u10``'s inputs for SEED on the CPU (x, y, test x,
#: test y, then the initial leaves in sorted order: dtype, shape, bytes),
#: taken from the harness before it took kinds
PARENT_DIGEST = \
    "71e56004b34f586630284feea7d96e350beb8a4398f32159ef04f2133d19983c"


def test_the_cnn_cells_inputs_are_the_parents_bits():
    c = tiny.cells.load_cell("cnn-paper-u10")
    with tiny.one_thread():
        inp = traffic.make_inputs(c, SEED, "cpu")
    h = hashlib.sha256()
    for a in (inp.users["x"], inp.users["y"], inp.test["x"], inp.test["y"],
              *[inp.init_host[k] for k in sorted(inp.init_host)]):
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    assert h.hexdigest() == PARENT_DIGEST


def _whole_change(glob, start):
    """The change norms as the records computed them from a whole global
    on the host."""
    return np.array([np.linalg.norm(glob[k].astype(np.float64)
                                    - start[k].astype(np.float64))
                     for k in sorted(start)])


def test_change_gaps_equal_those_of_the_whole_globals(monkeypatch):
    globs, news = [], []
    norms = fl.leaf_norms

    def keeping(model, glob):
        out = norms(model, glob)
        if isinstance(next(iter(glob.values())), np.ndarray):
            # a merged global's change from the initial global's host copy
            globs.append(({k: v.detach().cpu().numpy().copy()
                           for k, v in model.items()}, glob))
            news.append(out)
        return out
    monkeypatch.setattr(program, "leaf_norms", keeping)
    monkeypatch.setattr(fl, "leaf_norms", keeping)
    res = tiny.run(tiny.cell("cnn-paper-u10", users=4, k=2), seconds=0.0)
    # the program's three checked rounds, then the reference's
    assert len(globs) == 6 and res["correct"] is True
    old = [_whole_change(g, s) for g, s in globs]
    for new, want in zip(news, old):
        np.testing.assert_allclose(new, want, rtol=1e-12, atol=0)
    for name, p, q in (("step1_gap", 0, 3), ("change3_gap", 2, 5)):
        want = judge.norm_gap(old[p], old[q])
        got = res["checks"][name]["value"]
        assert abs(got - want) <= 1e-12 * want, (name, got, want)
