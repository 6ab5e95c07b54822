"""Build the port's CUDA sources at first use and load them with ctypes.

Each csrc/<name>.cu compiles with nvcc into its own shared library with a
plain C interface, polardecoding_tpu_torch/_build/<name>-<hash>.so, where
<hash> is taken from the source and the flags, so an edited source never
loads a stale library.  `build_all` starts one nvcc per source, all at once.
Importing this module needs no nvcc: a missing nvcc or a failed build raises
when a kernel is first built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# no --use_fast_math; -fmad=false keeps every a*b+c as the two roundings the
# plain version makes, which bit-equality with it needs
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    """nvcc from PATH, else $CUDA_HOME/bin (default /usr/local/cuda); raises
    BuildError if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    raise BuildError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                     "port's CUDA kernels cannot be built")


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, nvcc: str):
    """Start nvcc for one source; returns (process, tmp .so path, target)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = _target(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: str) -> str:
    """Wait for nvcc, keep its log beside the library, move the library in
    place; returns the compiler's output."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise BuildError(f"nvcc failed on csrc/{name}.cu "
                         f"(exit {proc.returncode}):\n{log}")
    with open(out[:-3] + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every csrc/*.cu that has no current library, one nvcc each,
    all started together; returns {name: compiler output} for those built."""
    with _lock:
        todo = [s for s in sources() if not os.path.exists(_target(s))]
        if not todo:
            return {}
        nvcc = find_nvcc()
        started = {s: _start(s, nvcc) for s in todo}
        logs, errors = {}, []
        for s, job in started.items():
            try:
                logs[s] = _finish(s, *job)
            except BuildError as e:
                errors.append(str(e))
        if errors:
            raise BuildError("\n".join(errors))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        out = _target(name)
        if not os.path.exists(out):
            build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(out)
    return lib
