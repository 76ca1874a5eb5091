"""Build and load the CUDA kernels of `repro_torch/csrc/`.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), all sources in parallel, at first use.  Libraries
go to ``build/cuda/`` at the root of the checkout (``REPRO_TORCH_BUILD``
overrides it) under a name that carries a hash of the sources, so an
edited source is never served by a stale library.  Loaded with
`ctypes`; every pointer and the stream are ``c_void_p``.

The pipelined schedule launches kernels from pool threads, so the first
build is behind a lock and the wrappers count launches with
`count_launch`, under another.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("rns_montmul.cu", "rns_montexp.cu", "rns_matvec.cu",
           "rns_fixedbase.cu", "cios_montmul.cu", "cios_montexp.cu",
           "cios_matvec.cu", "ring_matmul.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_uint)
_SIGNATURES = {
    "rns_montmul_launch": [_P, _LL, _P, _LL, _P, _I, _I, _I, _I, _I, _I,
                           _U, _P, _P, _P, _P],
    "rns_montmul_smem_bytes": [_I, _I, _I, _I, _I],
    "launch_floor": [_P],
    "rns_montexp_launch": [_P, _P, _LL, _I, _P, _P, _P, _I, _I, _I, _I, _U,
                           _P, _P, _P, _P],
    "rns_matvec_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                          _P, _P, _P, _I, _I, _I, _U, _P, _P, _P, _P],
    "rns_fixedbase_launch": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I,
                             _I, _I, _I, _U, _P, _P, _P, _P],
    "rns_fixedbase_cluster_slots": [_I, _I],
    "rns_fixedbase_smem_bytes": [_I, _I, _I, _I, _I, _I, _I],
    "rns_matvec_smem_bytes": [_I, _I, _I, _I, _I, _I],
    "cios_montmul_launch": [_P, _LL, _P, _LL, _P, _I, _I, _P, _I, _U, _P],
    "cios_montexp_launch": [_P, _P, _LL, _I, _P, _I, _I, _P, _I, _U, _P],
    "cios_matvec_launch": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _U,
                           _P],
    "cios_matvec_rows_fit": [_I, _I, _I],
    "ring_matmul_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                           _P],
}


@dataclasses.dataclass
class Built:
    """The loaded libraries, their launch entries by name, and what the
    build printed."""
    libs: dict
    fns: dict
    seconds: float
    log: str

    def fn(self, name: str):
        try:
            return self.fns[name]
        except KeyError:
            raise AttributeError(name) from None


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "cuda"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_built: Built | None = None


def load() -> Built:
    """Compile (if needed) and load every kernel library, once.
    Concurrent first calls wait for one build: unguarded, each would run
    nvcc into the same temporary paths."""
    global _built
    if _built is None:
        with _LOAD_LOCK:
            if _built is None:
                _built = _build_and_load()
    return _built


def count_launch(wrapper, shape=None) -> None:
    """One more launch of `wrapper` (its `.launches`, and `.shapes[shape]`
    when a shape is given), atomic across threads."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if shape is not None:
            wrapper.shapes[shape] += 1


def _build_and_load() -> Built:
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    targets = {src: out / f"lib{Path(src).stem}-{tag}.so" for src in SOURCES}
    t0 = time.perf_counter()
    logs = []
    missing = [s for s, so in targets.items() if not so.exists()]
    if missing:
        nvcc = _nvcc()
        procs = []
        for src in missing:
            tmp = targets[src].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, tmp, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"[{src}]\n{text.strip()}")
            if proc.returncode != 0:
                failed.append(src)
            else:
                os.replace(tmp, targets[src])
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed)
                               + "\n" + "\n".join(logs))
    seconds = time.perf_counter() - t0
    libs, fns = {}, {}
    for src, so in targets.items():
        lib = ctypes.CDLL(str(so))
        for name, args in _SIGNATURES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
                fns[name] = fn
        libs[src] = lib
    return Built(libs=libs, fns=fns, seconds=seconds,
                 log="\n".join(logs) if logs else "(cached build)")


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch entry."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")
