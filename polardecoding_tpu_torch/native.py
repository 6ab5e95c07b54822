"""ctypes loader for the repo's native exact-parity engine (native/golden_ref.c,
a float64 C engine with the reference programs' semantics), the port's
counterpart of polardecoding_tpu.native.

Builds the library on demand from native/golden_ref.c as it is, with the
system C compiler (cc, gcc or clang; -O2 -shared -fPIC -lm), into the port's
own build directory polardecoding_tpu_torch/_build/, rebuilding when the
source is newer; then binds:

  golden_noise(seed, nframes, N, sigma)    -> [nframes, N] float64
  golden_mc(N, K, info_set, seed, snr_db, nframes, decoder, iters)
      -> (errbit, errblock, u_hat [nframes, K] int8)
  golden_mc_list(N, K, info_set, seed, snr_db, nframes, list_size,
                 crc_exponents) -> (errbit, errblock, bits [nframes, K + r])

`decoder`: "bp" or "sc".  Golden mode holds the port's decoders against it
frame by frame at matched seeds.  Raises NativeUnavailable if no compiler
is present.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "golden_ref.c")
_BUILD = os.path.join(_PKG, "_build")
_LIB = os.path.join(_BUILD, "libgolden_ref.so")


class NativeUnavailable(RuntimeError):
    pass


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SRC):
        raise NativeUnavailable(f"no C engine source at {_SRC}")
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        os.makedirs(_BUILD, exist_ok=True)
        # build under a name of this process's own and rename, so that
        # processes building at once never load a half-written library
        tmp = f"{_LIB}.{os.getpid()}"
        for cc in ("cc", "gcc", "clang"):
            try:
                subprocess.run(
                    [cc, "-O2", "-shared", "-fPIC", "-o", tmp, _SRC, "-lm"],
                    check=True, capture_output=True,
                )
                break
            except (FileNotFoundError, subprocess.CalledProcessError) as e:
                err = e
        else:
            raise NativeUnavailable(f"no working C compiler: {err}")
        os.replace(tmp, _LIB)
    lib = ctypes.CDLL(_LIB)
    lib.pd_golden_noise.restype = None
    lib.pd_golden_mc.restype = None
    lib.pd_golden_mc_list.restype = None
    lib.pd_golden_noise.argtypes = [
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.pd_golden_mc.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_uint64, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int8),
    ]
    lib.pd_golden_mc_list.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_uint64, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int8),
    ]
    _lib = lib
    return lib


def golden_noise(seed: int, nframes: int, N: int, sigma: float) -> np.ndarray:
    lib = _load()
    out = np.empty((nframes, N), dtype=np.float64)
    lib.pd_golden_noise(
        seed, nframes, N, sigma,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def golden_mc_list(
    N: int,
    K: int,
    info_set: np.ndarray,
    seed: int,
    snr_db: float,
    nframes: int,
    list_size: int = 8,
    crc_exponents=None,
    return_bits: bool = True,
):
    """Native SCL / CA-SCL Monte-Carlo at matched seeds.  info_set carries the
    K + r info channels for CA-SCL (pass crc_exponents) or K for plain SCL.
    Returns (errbit, errblock, bits [nframes, len(info_set)] or None)."""
    lib = _load()
    info = np.ascontiguousarray(info_set, dtype=np.int32)
    KI = info.shape[0]
    if crc_exponents:
        exps = np.ascontiguousarray(crc_exponents, dtype=np.int32)
        exps_p = exps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        n_crc = len(crc_exponents)
        if KI != K + max(crc_exponents):
            raise ValueError(f"info_set has {KI} channels, not K + r")
    else:
        exps_p, n_crc = None, 0
        if KI != K:
            raise ValueError(f"info_set has {KI} channels, not K = {K}")
    eb = ctypes.c_int64()
    ebl = ctypes.c_int64()
    bits = np.empty((nframes, KI), dtype=np.int8) if return_bits else None
    lib.pd_golden_mc_list(
        N, K, KI, info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        exps_p, n_crc, seed, snr_db, nframes, list_size,
        ctypes.byref(eb), ctypes.byref(ebl),
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
        if bits is not None else None,
    )
    return eb.value, ebl.value, bits


def golden_mc(
    N: int,
    K: int,
    info_set: np.ndarray,
    seed: int,
    snr_db: float,
    nframes: int,
    decoder: str = "sc",
    iters: int = 100,
    return_bits: bool = True,
):
    lib = _load()
    info = np.ascontiguousarray(info_set, dtype=np.int32)
    if info.shape != (K,):
        raise ValueError(f"info_set has shape {info.shape}, not ({K},)")
    eb = ctypes.c_int64()
    ebl = ctypes.c_int64()
    bits = np.empty((nframes, K), dtype=np.int8) if return_bits else None
    lib.pd_golden_mc(
        N, K, info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        seed, snr_db, nframes, {"bp": 0, "sc": 1}[decoder], iters,
        ctypes.byref(eb), ctypes.byref(ebl),
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
        if bits is not None else None,
    )
    return eb.value, ebl.value, bits
