"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. Builds happen at first use, from the
repository's sources only, into ``runtime.device.KERNEL_BUILD_DIR``; the
library name carries a hash of the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source or header rebuilds and an
unchanged one is reused. A failed build raises with
nvcc's stderr. Each source has its own lock, so different sources build
at once (one nvcc each) and one source builds once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Tuple

from valkey_search_tpu_torch.runtime.device import KERNEL_BUILD_DIR

CSRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_locks = {name[:-3]: threading.Lock() for name in os.listdir(CSRC_DIR)
          if name.endswith(".cu")}
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds spent building, 0.0 when reused; ptxas report)
BUILD_INFO: Dict[str, Tuple[float, str]] = {}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin)")


def _digest(src: str) -> str:
    """Hash of the source, every ``csrc/*.cuh`` header it may include, and
    the flags: an edited header rebuilds every source."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(name for name in os.listdir(CSRC_DIR)
                     if name.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, name) for name in headers]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    with _locks[name]:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        digest = _digest(src)
        os.makedirs(KERNEL_BUILD_DIR, exist_ok=True)
        out = os.path.join(KERNEL_BUILD_DIR, f"lib{name}-{digest}.so")
        if os.path.exists(out):
            BUILD_INFO[name] = (0.0, "")
        else:
            t0 = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=KERNEL_BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                    capture_output=True, text=True,
                )
                if proc.returncode != 0:
                    raise KernelBuildError(
                        f"nvcc failed for {src} (exit {proc.returncode}):\n"
                        f"{proc.stderr}"
                    )
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            BUILD_INFO[name] = (time.perf_counter() - t0, proc.stderr)
        lib = ctypes.CDLL(out)
        _libs[name] = lib
        return lib
