"""Build and load the hand-written CUDA kernels (csrc/*.cu) and the host
library of the motion boxes (native/golfer_host.cpp).

Each CUDA source is compiled by `nvcc` for sm_90a, the host source by `g++`,
into a shared library with a plain C interface under
`golfaction_tpu_torch/build/`, at first use, and loaded with ctypes.  The
library name carries a hash of its source (and of the headers in csrc/), so
an edited kernel is rebuilt and a stale build is never loaded.  The compiler's
output (`-Xptxas -v`: registers, shared memory and spills of every kernel) is
kept beside the library; `resource_usage` reads it.  Every C entry
point returns `cudaGetLastError()` after its launches; `check` raises on it.

Nothing here runs at import time: this module is imported on machines with
no CUDA toolkit, where only the kernels' plain versions run (and the host
library still builds, with g++).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
NATIVE = PKG / "native"
BUILD = PKG / "build"
SOURCES = ("preprocess", "gcn_tail", "softdtw", "decode", "softdtw_bwd", "requant",
           "group_norm")
HOST_SOURCES = ("golfer_host",)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the motion-box library "
                           "(native/golfer_host.cpp) needs a C++ compiler")
    return found


def _source(name: str) -> Path:
    return NATIVE / f"{name}.cpp" if name in HOST_SOURCES else CSRC / f"{name}.cu"


def _lib_path(name: str) -> Path:
    src, flags = _source(name).read_bytes(), GXX_FLAGS
    if name not in HOST_SOURCES:
        flags = NVCC_FLAGS
        for header in sorted(CSRC.glob("*.cuh")):
            src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}_{digest}.so"


def _start_build(name: str):
    """Start the compiler for one source; returns (process, tmp path, final
    path) or None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if name in HOST_SOURCES:
        cmd = [_gxx(), *GXX_FLAGS, "-o", str(tmp), str(_source(name))]
    else:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish_build(job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{proc.args[0]} failed for {out.name}:\n"
                           f"{log.decode(errors='replace')}")
    out.with_suffix(".log").write_bytes(log)
    os.replace(tmp, out)


def build_all(names=SOURCES) -> None:
    """Compile every listed source that is not built yet, one compiler each,
    all started together."""
    jobs = [j for j in (_start_build(n) for n in names) if j is not None]
    for job in jobs:
        _finish_build(job)


def _demangled_kernel(entry: str) -> str:
    """A mangled `__global__` name -> `name<int and bool template args>`:
    the identifier ending in `_kernel` whose length prefix (the digits just
    before it) matches it."""
    for m in re.finditer(r"\d+(?=[A-Za-z_])", entry):
        for k in range(len(m.group(0))):
            end = m.end() + int(m.group(0)[k:])
            name = entry[m.end():end]
            if end <= len(entry) and name.endswith("_kernel"):
                targs = re.match(r"(?:I|L[ib]\d+E)*", entry[end:]).group(0)
                args = [v if t == "i" else ("false", "true")[int(v)]
                        for t, v in re.findall(r"L([ib])(\d+)E", targs)]
                return name + (f"<{', '.join(args)}>" if args else "")
    return entry


def resource_usage(name: str) -> list[dict]:
    """What ptxas reported for each kernel of csrc/<name>.cu when it was
    built: name (with its template arguments), registers, static
    shared memory, spill bytes."""
    build_all((name,))
    return ptxas_rows(_lib_path(name).with_suffix(".log").read_text(errors="replace"))


def ptxas_rows(log: str) -> list[dict]:
    """The kernels of one `nvcc -Xptxas -v` log, as resource_usage gives them."""
    rows = []
    for entry, body in re.findall(r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|\Z)",
                                  log, flags=re.S):
        regs = re.search(r"Used (\d+) registers", body)
        smem = re.search(r"(\d+) bytes smem", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        entry = _demangled_kernel(entry)
        rows.append({"kernel": entry, "registers": int(regs.group(1)) if regs else None,
                     "static_smem": int(smem.group(1)) if smem else 0,
                     "spill_bytes": int(spill.group(1)) + int(spill.group(2)) if spill else None})
    return rows


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (or native/<name>.cpp), building
    it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "l": ctypes.c_int64}


def bind(name: str, symbol: str, sig: str, restype=ctypes.c_int):
    """C entry point `symbol` of library `name` with argument types from
    `sig` (p = pointer or stream, i = int, f = float, l = int64); returns
    `restype` (int unless given)."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = restype
        fn.argtypes = [_CTYPES[c] for c in sig]
        _fns[(name, symbol)] = fn
    return fn


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t, dtype, ndim: int, what: str) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and rank `ndim`."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
