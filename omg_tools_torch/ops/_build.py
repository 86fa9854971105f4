"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (sm_90a) into
a shared library with a plain C interface and loaded with ``ctypes``.  The
build runs at first use, from the sources in the checkout, into
``build/omg_tools_torch/`` at the repository root (listed in
``.gitignore``); the library's file name carries a hash of its source,
the other files of ``csrc/`` and the flags, so an edited source or an
included file is rebuilt and an unchanged one is reused.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build_all", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "omg_tools_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# C entry points per source: name -> argument types (restype is int)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "chol_solve": {
        "omg_chol_solve_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    },
    "chol_solve_f64": {
        "omg_chol_solve_f64": (_P, _P, _P, _I, _I, _I, _I, _P),
    },
    "fused_alm": {
        "omg_fused_inner_f32": (_P,) * 10 + (_I, _P, _P, _P, _I, _I, _I,
                                             _P, _P),
        "omg_fused_layout": (_P, _I),
        "omg_fused_smem": (_P, _I),
    },
}

_loaded = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in ([os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME
                 else []) + [shutil.which("nvcc")]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name):
    """The library's path, named by a hash of its source, every other file
    of ``csrc/`` (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for other in sorted(CSRC.glob("*.cu*")):
        h.update(other.name.encode() + other.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None):
    """Compile every named source (default: all of ``csrc/``) that has no
    up-to-date library yet, one ``nvcc`` per source, all started together.
    Returns {name: library path}.  Raises with the compiler's output when a
    build fails."""
    names = sorted(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: _lib_path(name) for name in names}


def load(name):
    """The loaded library of one source, built first if needed."""
    if name not in _loaded:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]
