"""Builds the CUDA sources under ``csrc/`` with ``nvcc`` and loads them
with ``ctypes``.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` launchers (raw
pointers, sizes, the stream; return value ``cudaGetLastError()``) and
includes no PyTorch header, so a build takes seconds. At first use every
source is compiled for ``sm_90a`` — one ``nvcc`` process per source, all
started together — into ``build/repro_torch_kernels/`` at the
repository root, one shared library per source, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source rebuilds and an unchanged one is reused. Nothing is fetched and
nothing is prebuilt; a failed build or load raises with the compiler's
output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: repository root = .../src/repro_torch/kernels -> three levels up
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL, _U64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_uint64, ctypes.c_float)

#: source stem -> {function: argtypes}; every pointer and the stream is a
#: ``c_void_p`` (a bare Python int would be cut to 32 bits)
SIGNATURES = {
    "fused_sgd": {
        "repro_fused_sgd_max_leaves": (),
        "repro_fused_sgd_leaves": (_P, _P, _P, _I, _F, _I, _P),
    },
    "delta_norm": {
        "repro_delta_norm_max_leaves": (),
        "repro_delta_norm_leaves": (_P, _P, _P, _I, _I, _P, _P, _LL, _P, _LL,
                                    _I, _P),
    },
    "combine": {
        "repro_combine_max_k": (),
        "repro_gather_combine": (_P, _P, _P, _P, _P, _I, _I, _LL, _I, _P),
        "repro_fedavg_combine": (_P, _P, _P, _I, _LL, _I, _P),
        "repro_aircomp_combine": (_P, _P, _P, _P, _P, _P, _I, _I, _LL, _I,
                                  _P),
        "repro_robust_combine": (_P, _P, _P, _P, _P, _I, _LL, _I, _P),
    },
    "contention": {
        "repro_contention_min": (_P, _P, _P, _I, _I, _P),
        "repro_contention_expiry": (_P, _P, _P, _P, _P, _I, _I, _P),
        "repro_contention_transition": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _I, _I, _I, _P),
        "repro_contention_loop_shared_lanes": (),
        "repro_contention_loop": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _U64, _P),
    },
    "server_opt": {
        "repro_server_opt_max_leaves": (),
        "repro_server_opt_leaves": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                                    _I, _P),
    },
    "token_sum": {
        "repro_token_sum": (_P, _P, _I, _LL, _I, _P),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` /
    ``CUDA_PATH``, else the toolkit's usual place. Raises if absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels are compiled on the machine that runs them")


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every source whose library is missing (in parallel) and
    return ``{stem: path of the .so}``. With ``verbose`` the resource
    usage ``ptxas`` reports is printed."""
    targets = {stem: _target(CSRC / f"{stem}.cu") for stem in SIGNATURES}
    todo = {stem: out for stem, out in targets.items() if not out.is_file()}
    if not todo:
        return targets
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (tmp, out, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failures = []
    for stem, (tmp, out, cmd, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"$ {' '.join(cmd)}\n{log}")
            continue
        if verbose and log:
            print(log, flush=True)
        os.replace(tmp, out)     # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return targets


def library(stem: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<stem>.cu`` with ``argtypes``
    set (built, with its siblings, on first use)."""
    lib = _LIBS.get(stem)
    if lib is None:
        path = build_all()[stem]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[stem].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[stem] = lib
    return lib


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype) -> int:
    """The launchers' dtype code; raises for anything but f32 / bf16."""
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(
            f"CUDA kernels take float32 or bfloat16, got {dtype}") from None


def launch_stream(t: torch.Tensor) -> int:
    """PyTorch's current stream, as the integer handle the launchers
    take. A kernel launches on the CURRENT device, so ``t`` must lie on
    it (switching devices around every launch would cost more than the
    small kernels themselves)."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensor on {t.device} but the current CUDA device is "
            f"{torch.cuda.current_device()}: select it with "
            "torch.cuda.set_device / torch.cuda.device first")
    return torch.cuda.current_stream().cuda_stream


def check_launch(rc: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
