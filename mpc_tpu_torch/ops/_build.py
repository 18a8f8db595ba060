"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/lib<name>-<hash>.so`` beside the package (``build/`` is
git-ignored), at first use.  The hash covers the source, every source it
includes (``fused_gn_st.cu`` is ``fused_gn.cu`` with the ST model;
``fused_ip_st.cu`` and ``fused_ip_ks_ring.cu`` are ``fused_ip_ring.cu``
with the ST model and with the KS model's boundary rows), every shared
header ``csrc/*.cuh`` and the flags, so an edited source or header builds
anew and an unchanged one is loaded as it is.  The fused libraries export
the same C names; each is loaded on its own handle.
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
# C signatures: name -> (function, argtypes)
SIGNATURES = {
    "fused_gn": ("fused_gn_solve", [_P] * 21),
    "fused_ip": ("fused_ip_solve", [_P] * 15),
    "riccati": ("riccati_sweep", [_P] * 15),
    "fused_gn_st": ("fused_gn_solve", [_P] * 21),
    # fused_ip_ring.cu: the Newton state's 11 buffers after the others
    "fused_ip_st": ("fused_ip_solve", [_P] * 26),
    "fused_ip_ks_ring": ("fused_ip_solve", [_P] * 26),
}
# a source that includes another source
_INCLUDED_SOURCE = re.compile(r'#include "(\w+\.cu)"')

_loaded: dict = {}


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def lib_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes: named by a hash of the
    source, of the sources it includes, of every header in ``csrc`` (any
    source may include any of them) and of the flags."""
    src = (csrc / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src)
    for inc in _INCLUDED_SOURCE.findall(src.decode()):
        key.update(inc.encode() + b"\0" + (csrc / inc).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        key.update(header.name.encode() + b"\0" + header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; (path, proc)."""
    out = lib_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> str:
    """Wait for nvcc, move the library into place; returns its output
    (``-Xptxas -v``: registers, spills, shared memory)."""
    if job is None:
        log = out.with_suffix(".log")
        return log.read_text() if log.exists() else ""
    proc, tmp = job
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{text}")
    out.with_suffix(".log").write_text(text)
    os.replace(tmp, out)
    return text


def build_all(names=None) -> dict:
    """Build every kernel (one nvcc per source, in parallel); returns the
    compiler output of each."""
    names = list(SIGNATURES) if names is None else list(names)
    jobs = {n: _start(n) for n in names}
    return {n: _finish(n, *jobs[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built at first use."""
    if name not in _loaded:
        out, job = _start(name)
        _finish(name, out, job)
        lib = ctypes.CDLL(str(out))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]
