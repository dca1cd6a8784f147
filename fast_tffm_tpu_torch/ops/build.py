"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source into a shared library with a plain C
interface at first use; ``ctypes`` loads it. The library lands in
``fast_tffm_tpu_torch/_build/`` (listed in ``.gitignore``) under a name
keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited kernel is rebuilt and an unchanged one is reused
by later processes.

Importing this module needs no CUDA toolkit: ``nvcc`` runs only when a
kernel is first launched, or when ``build()`` is called directly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC = os.path.join(_PKG, "csrc")
FM_SCORE_SRC = os.path.join(CSRC, "fm_score.cu")
FM_SCORE_BWD_SRC = os.path.join(CSRC, "fm_score_bwd.cu")
OFFLOAD_ROWS_SRC = os.path.join(CSRC, "offload_rows.cu")
SOURCES = (FM_SCORE_SRC, FM_SCORE_BWD_SRC, OFFLOAD_ROWS_SRC)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # source path -> loaded library


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install path."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are compiled at first use")


def library_path(src: str) -> str:
    """Where the library built from ``src`` lives: keyed by a hash of
    the source bytes, the headers in ``csrc/`` and the compiler flags."""
    h = hashlib.sha256()
    headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                     if f.endswith(".cuh"))
    for path in (src, *headers):
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build(src: str = FM_SCORE_SRC,
          log: Optional[Callable[[str], None]] = None) -> str:
    """Compile ``src`` unless its library already exists; returns the
    library path. ``log`` receives nvcc's output (the ``-Xptxas=-v``
    register and spill report) and the build time. A failed compile
    raises with nvcc's output."""
    out = library_path(src)
    if os.path.isfile(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Compile to a private name, then rename: a process building the
    # same library at the same time never loads a half-written one.
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    if log is not None:
        log(f"built {os.path.basename(out)} in {seconds:.1f}s\n"
            f"{proc.stdout}{proc.stderr}")
    return out


def build_all(sources: Sequence[str] = SOURCES,
              log: Optional[Callable[[str], None]] = None) -> List[str]:
    """Build every source at once, one nvcc process each; returns the
    library paths in ``sources`` order."""
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        return list(pool.map(lambda src: build(src, log), sources))


def _load(src: str, signatures) -> ctypes.CDLL:
    """The library built from ``src`` (built if needed), loaded once
    per process, with every C signature in ``signatures`` (name ->
    (argtypes, restype)) declared: pointers and the stream as
    ``c_void_p``, so ctypes never cuts a 64-bit address to an int."""
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = ctypes.CDLL(build(src))
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _libs[src] = lib
        return lib


_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)


def load_fm_score() -> ctypes.CDLL:
    """The fm_score (forward) library: fm_score_forward(params, idx,
    vals, out, n_rows, D, B, L, device, stream)."""
    return _load(FM_SCORE_SRC, {
        "fm_score_forward": ([_P] * 4 + [_LL] + [_I] * 4 + [_P], _I),
        "fm_score_error_string": ([_I], ctypes.c_char_p)})


def load_fm_score_bwd() -> ctypes.CDLL:
    """The fm_score_bwd (backward) library: fm_score_bwd(params, idx,
    vals, g, dparams, dvals, acc, row_max, n_rows, D, B, L, need_dx,
    device, stream)."""
    return _load(FM_SCORE_BWD_SRC, {
        "fm_score_bwd": ([_P] * 8 + [_LL] + [_I] * 5 + [_P], _I),
        "fm_score_bwd_error_string": ([_I], ctypes.c_char_p)})


def load_offload_rows() -> ctypes.CDLL:
    """The offload row library: offload_gather(table, ids, out, n_rows,
    D, U, device, stream), offload_adagrad(table, acc, ids, rows, grad,
    lr, n_rows, D, U, device, stream), and the page-locking calls
    offload_host_register(ptr, nbytes, device),
    offload_host_unregister(ptr) and offload_device_pointer(ptr,
    &dev_ptr)."""
    return _load(OFFLOAD_ROWS_SRC, {
        "offload_gather": ([_P] * 3 + [_LL, _I, _LL, _I, _P], _I),
        "offload_adagrad": ([_P] * 5 + [_F, _LL, _I, _LL, _I, _P], _I),
        "offload_host_register": ([_P, _LL, _I], _I),
        "offload_host_unregister": ([_P], _I),
        "offload_device_pointer": ([_P, ctypes.POINTER(_P)], _I),
        "offload_error_string": ([_I], ctypes.c_char_p)})
