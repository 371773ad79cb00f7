"""Build the port's CUDA kernels from ``vfr_tpu_torch/csrc/*.cu`` and load
them with ctypes.

Each source compiles on first use into its own shared library with a plain
C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

into ``vfr_tpu_torch/_build/`` (ignored by git).  The file name carries a
hash of the source, of the shared headers (``csrc/*.cuh``) and of the
flags, so an edited source or header is rebuilt and never loaded stale.  Nothing is fetched: the sources in the package are all it
builds from.  ``build_all`` starts one ``nvcc`` per source at once.

``nvcc`` is found as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then under
``/usr/local/cuda``.  Without it the build raises; nothing falls back.

Host libraries (``csrc/host/*.cc``: the packed feature store's reader) are
built the same way with ``g++ -O3 -shared`` by ``load_host``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signature of every entry point, by source name
SIGNATURES = {
    "lstm_recurrence": {
        "vfr_lstm_layer": [_P] * 15 + [_I] * 6 + [_P],
        "vfr_lstm_layer_persistent": [_P] * 12 + [_I] * 10 + [_P, _P],
    },
    "gru_recurrence": {
        "vfr_gru_layer": [_P] * 15 + [_I] * 6 + [_P],
        "vfr_gru_layer_persistent": [_P] * 13 + [_I] * 10 + [_P, _P],
    },
    "distance_select": {
        "vfr_distance_select": [_P, _P, _P, _F, _F, _I, _I, _I, _I, _I, _I,
                                _I, _P, _P, _P],
        "vfr_distance_select_mma": [_P, _P, _P, _F, _F] + [_I] * 10
                                   + [_P] * 8,
    },
    "coarse_blockmax": {
        "vfr_coarse_blockmax": [_P] * 4 + [_I] * 5 + [_P],
        "vfr_coarse_blockmax_mma": [_P] * 4 + [_I] * 7 + [_P],
    },
}

# host libraries (csrc/host/<name>.cc), built with g++
HOST_CSRC = os.path.join(CSRC, "host")
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_I64 = ctypes.c_int64
HOST_SIGNATURES = {
    "vfr_io": {
        "vfr_open": ([ctypes.c_char_p], _P),
        "vfr_close": ([_P], None),
        "vfr_num_videos": ([_P], _I64),
        "vfr_rows": ([_P], ctypes.c_int32),
        "vfr_dim": ([_P], ctypes.c_int32),
        "vfr_find": ([_P, ctypes.c_char_p], _I64),
        "vfr_id_at": ([_P, _I64, ctypes.c_char_p], None),
        "vfr_gather": ([_P, ctypes.POINTER(_I64), _I64,
                        ctypes.POINTER(ctypes.c_float), ctypes.c_int32],
                       None),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from vfr_tpu_torch/csrc at first use")


def library_path(name: str) -> str:
    h = hashlib.sha1()
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for src in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def _start(name: str, extra_flags=()):
    """Popen of the nvcc that builds ``name`` (None when already built)."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    """Wait for ``job``; the compiler's output ("" when already built)."""
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed building {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: List[str] = None,
              resource_usage: bool = False) -> Dict[str, str]:
    """Compile every kernel source (one nvcc each, all started together).
    Returns each compiler's output; with ``resource_usage`` that holds
    ptxas's registers, shared memory and spills of every kernel."""
    names = list(SIGNATURES) if names is None else names
    extra = ("-Xptxas", "-v") if resource_usage else ()
    with _lock:
        jobs = {n: _start(n, extra) for n in names}
        return {n: _finish(n, job) for n, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _finish(name, _start(name))
        lib = ctypes.CDLL(library_path(name))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def host_library_path(name: str) -> str:
    h = hashlib.sha1()
    with open(os.path.join(HOST_CSRC, name + ".cc"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(HOST_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``csrc/host/<name>.cc``, built with ``g++``
    (``$CXX`` when set) on first use; raises when the build fails."""
    with _lock:
        lib = _libs.get("host:" + name)
        if lib is not None:
            return lib
        out = host_library_path(name)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [os.environ.get("CXX", "g++"), *HOST_FLAGS, "-o", tmp,
                   os.path.join(HOST_CSRC, name + ".cc")]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=120)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"building {name}.cc: {e}") from e
            if r.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(
                    f"g++ failed building {name}.cc:\n{r.stdout}{r.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        for fn, (argtypes, restype) in HOST_SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _libs["host:" + name] = lib
        return lib
