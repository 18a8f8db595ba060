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
:func:`build_all` starts one ``nvcc`` per source, all at once;
:func:`start_all` starts them and returns, and :func:`load` of a library
then waits for its own ``nvcc`` alone.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
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
# name -> (library, nvcc job or None): started by start_all, not waited for
_pending: dict = {}
# name -> (compiler output, seconds from its start to its library in place)
_built: dict = {}


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
    """Start nvcc for one source unless its library exists; (path, job):
    job None, or (process, temporary output, a thread reading its output
    into a dict with the seconds from its start to its end)."""
    out = lib_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    box = {}

    def read():   # drained at once, so a long log never stalls nvcc
        box["text"] = proc.communicate()[0]
        box["seconds"] = time.perf_counter() - t0
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return out, (proc, tmp, reader, box)


def _finish(name: str, out: Path, job) -> tuple:
    """Wait for nvcc, move the library into place; returns its output
    (``-Xptxas -v``: registers, spills, shared memory) and its seconds
    (0.0 where the library was there before)."""
    if job is None:
        log = out.with_suffix(".log")
        return (log.read_text() if log.exists() else ""), 0.0
    proc, tmp, reader, box = job
    reader.join()
    text = box["text"]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{text}")
    out.with_suffix(".log").write_text(text)
    os.replace(tmp, out)
    return text, box["seconds"]


def start_all(names=None) -> None:
    """Start one nvcc per source (each not built, started or loaded yet),
    all at once, and return; :func:`load` of a library waits for its own,
    :func:`build_all` for all of them."""
    for n in (list(SIGNATURES) if names is None else names):
        if n not in _pending and n not in _built:
            _pending[n] = _start(n)


def done(name: str) -> bool:
    """Whether the library of ``name`` is in place or its nvcc has ended."""
    if name in _pending:
        job = _pending[name][1]
        return job is None or job[0].poll() is not None
    return name in _built or lib_path(name).exists()


def _wait(name: str) -> str:
    """The compiler output of ``name``, its library in place (waiting for
    the nvcc that :func:`start_all` started, or building it here)."""
    if name not in _built:
        out, job = _pending.pop(name, None) or _start(name)
        _built[name] = _finish(name, out, job)
    return _built[name][0]


def seconds() -> dict:
    """Per library built here, the seconds its nvcc ran (0.0 where the
    library was there before)."""
    return {n: s for n, (_, s) in _built.items()}


def build_all(names=None) -> dict:
    """Build every kernel (one nvcc per source, in parallel); returns the
    compiler output of each."""
    names = list(SIGNATURES) if names is None else list(names)
    start_all(names)
    return {n: _wait(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built at first use."""
    if name not in _loaded:
        _wait(name)
        lib = ctypes.CDLL(str(lib_path(name)))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]
