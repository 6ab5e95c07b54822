"""Build the port's CUDA sources at first use and load them with ctypes.

Each csrc/<name>.cu compiles with nvcc into its own shared library with a
plain C interface, polardecoding_tpu_torch/_build/<name>-<hash>.so, where
<hash> is taken from the source, the shared headers (csrc/*.cuh) and the
flags, so an edited source or header never loads a stale library.  `build_all` starts one nvcc per source, all at once.
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

import torch

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


def use_kernel(x, engine: str, what: str) -> bool:
    """Whether the dispatcher `what` launches its CUDA kernel on x (a tensor
    or a torch.device): with engine "auto" on CUDA; "plain" is the plain
    version on any device.  Another engine raises ValueError."""
    if engine not in ("auto", "plain"):
        raise ValueError(f"{what}: unknown engine {engine!r} (expected "
                         "'auto' or 'plain')")
    return engine == "auto" and getattr(x, "device", x).type == "cuda"


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
    """The library's path, hashed over the flags, the source and every
    shared header of csrc/ (*.cuh)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
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


class LaunchError(RuntimeError):
    pass


def launch(name: str, argtypes, device, *args) -> None:
    """Call csrc/<name>.cu's C entry `<name>_launch(*args, stream)` on the
    current stream of `device`, without synchronising.  argtypes are the
    ctypes types of args.  Raises LaunchError with the library's
    `<name>_error_string` when the entry refuses the launch."""
    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    err = getattr(lib, f"{name}_error_string")
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise LaunchError(f"{name} kernel launch failed: "
                          f"{err(rc).decode()} ({rc})")
