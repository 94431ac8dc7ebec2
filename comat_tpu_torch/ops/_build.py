"""Build the sources under `csrc/` and bind them with ctypes.

Each CUDA source is compiled on first use by `nvcc` for `sm_90a` into a
shared library with a plain C interface, under `build/kernels/` at the
repository root (listed in .gitignore). The file name carries a hash of the
source, so an edited kernel is rebuilt and a stale library is never loaded.
`build(names)` starts one `nvcc` per source at once and waits for all.

The host sources (`csrc/<name>.cpp`, the native host runtime) are compiled
the same way by g++, the host compiler nvcc itself needs, into
`build/host/` (`build_host`); they need no card, so the CPU tests build
and run them too. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, List, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
HOST_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "host")
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> str:
    """Path of the library built from `csrc/<name>.cu` as it stands now,
    with the headers under `csrc/` that it may include."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no current library, all at
    once. Returns {name: library path}. The compiler's report (registers,
    shared memory, spills) is kept beside each library as `<lib>.log`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    running: List[Tuple[str, str, subprocess.Popen]] = []
    try:
        for name, path in paths.items():
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, name + ".cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            running.append((name, tmp, proc))
        failed = []
        for name, tmp, proc in running:
            out, _ = proc.communicate()
            with open(paths[name] + ".log", "w") as f:
                f.write(out)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    finally:
        for _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def host_library_path(name: str) -> str:
    """Path of the library built from `csrc/<name>.cpp` as it stands now,
    with the `.inc` tables under `csrc/` that it may include."""
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    tables = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".inc"))
    for fname in [name + ".cpp", *tables]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(HOST_BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_host(name: str) -> str:
    """Compile `csrc/<name>.cpp` with g++ unless its current library
    exists; returns the library's path. Raises with the compiler's output
    if the build fails."""
    path = host_library_path(name)
    if os.path.exists(path):
        return path
    compiler = os.environ.get("CXX") or shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found: the native host library cannot be built")
    os.makedirs(HOST_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(
            [compiler, *HOST_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"host build of {name}.cpp failed ({compiler} exit "
                               f"{proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


class CudaKernel:
    """One C entry point of one source, loaded at its first launch.

    `launches` counts the launches that this process made through
    `launch`, and only those; `launches_by_shape` splits the same count
    by the shape key each launch names."""

    def __init__(self, source: str, symbol: str, argtypes: List):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.launches_by_shape: collections.Counter = collections.Counter()
        self._fn = None

    def _function(self):
        if self._fn is None:
            path = build([self.source])[self.source]
            fn = getattr(ctypes.CDLL(path), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_shape.clear()

    def launch(self, *args, shape: Tuple = ()) -> None:
        """Call the entry point on PyTorch's current stream; raise if the
        launch was refused."""
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        err = self._function()(*args, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} launch failed with cudaError {err}"
            )
        self.launches += 1
        self.launches_by_shape[shape] += 1
