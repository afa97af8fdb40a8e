"""Build and load the hand-written CUDA kernels (`vcm_ts_tpu_torch/csrc`).

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, loaded with ctypes. Nothing is built when
a module is imported: the first wrapper that launches a kernel on a CUDA
tensor calls `launcher()`, which builds every missing library at once (one
`nvcc` process per source, all started together) into `csrc/build/`.
Library names carry a hash of their source, so an edited kernel rebuilds.

Each kernel wrapper adds one to its count in `LAUNCHES` where it launches
(`count_launch`, under a lock: sessions on several threads launch at
once); a run resets the counts with `reset_launches()` and reads them
afterwards to show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

SOURCES = ("warp", "subpel_conv1x1", "pixel_shuffle", "warp_twopass",
           "warp_bwd", "space_to_depth")
CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"warp": 0, "subpel_conv1x1": 0, "pixel_shuffle_relayout": 0,
            "warp_twopass": 0, "warp_bwd": 0, "space_to_depth": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point and argument types of each source (see the .cu files)
SIGNATURES = {
    "warp": ("vcm_warp", [ctypes.POINTER(_P), ctypes.POINTER(_P),
                          ctypes.POINTER(_I), _I, _P] + [_I] * 7 + [_P]),
    "subpel_conv1x1": ("vcm_subpel_conv1x1", [_P] * 4 + [_I] * 7 + [_P]),
    "pixel_shuffle": ("vcm_pixel_shuffle_relayout", [_P] * 2 + [_I] * 6
                      + [_P]),
    "warp_twopass": ("vcm_warp_twopass", [_P, _P, _I, _P] + [_I] * 7 + [_P]),
    "warp_bwd": ("vcm_warp_bwd", [ctypes.POINTER(_P)] * 3
                 + [ctypes.POINTER(_I), _I, _P, _P] + [_I] * 6 + [_P]),
    "space_to_depth": ("vcm_space_to_depth", [_P] * 2 + [_I] * 6 + [_P]),
}

_libs: dict = {}
_lock = threading.Lock()
_count_lock = threading.Lock()
build_log: dict = {}  # source name -> nvcc's output (ptxas register report)


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def _so_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_all() -> dict:
    """Compile every missing kernel library in parallel; load all of them.
    Returns {source name: C launcher}. Raises if any build fails."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name in SOURCES:
            out = _so_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.tmp{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, name + ".cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate(timeout=600)
            build_log[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in SOURCES:
            entry, argtypes = SIGNATURES[name]
            fn = getattr(ctypes.CDLL(_so_path(name)), entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = fn
        return _libs


def launcher(name: str):
    """The C launcher of source `name` (built on first use); it returns a
    cudaError_t."""
    libs = _libs if len(_libs) == len(SOURCES) else build_all()
    return libs[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {rc}")


def stream_ptr(t) -> int:
    """PyTorch's current stream on `t`'s device, as the raw cudaStream_t
    (the call Triton's launcher makes; cheaper than a Stream object)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


def dtype_code(t) -> int:
    """0: float32, 1: bfloat16 — the only dtypes the kernels take."""
    import torch

    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
