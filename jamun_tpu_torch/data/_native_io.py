"""ctypes bindings of the port's trajio library (`csrc/trajio.cpp`;
counterpart of `jamun_tpu/data/_native_io.py`): DCD and XTC, positions in
nm as float32 [frames, atoms, 3]. The library is built with g++ at the
first call (`build_native.build`); a failed build raises."""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from jamun_tpu_torch.data.build_native import build

__all__ = ["read_dcd", "write_dcd", "read_xtc", "write_xtc"]

_INT_P = ctypes.POINTER(ctypes.c_int)
_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "trajio_dcd_info": [ctypes.c_char_p, _INT_P, _INT_P],
    "trajio_dcd_read": [ctypes.c_char_p, _FLOAT_P, ctypes.c_int],
    "trajio_dcd_write": [ctypes.c_char_p, _FLOAT_P, ctypes.c_int, ctypes.c_int],
    "trajio_xtc_info": [ctypes.c_char_p, _INT_P, _INT_P],
    "trajio_xtc_read": [ctypes.c_char_p, _FLOAT_P, ctypes.c_int],
    "trajio_xtc_write": [ctypes.c_char_p, _FLOAT_P, ctypes.c_int, ctypes.c_int, ctypes.c_float],
}
_lib = None
_lock = threading.Lock()


def _fn(name: str):
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for entry, argtypes in _SIGNATURES.items():
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
            _lib = lib
    return getattr(_lib, name)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_FLOAT_P)


def _frames(pos_nm: np.ndarray) -> np.ndarray:
    """Positions as the codecs take them: C-contiguous float32 [frames, atoms, 3]."""
    pos = np.ascontiguousarray(pos_nm, np.float32)
    if pos.ndim != 3 or pos.shape[2] != 3:
        raise ValueError(f"positions must be [frames, atoms, 3], got {pos.shape}")
    return pos


def read_dcd(path: str) -> np.ndarray:
    nf, na = ctypes.c_int(), ctypes.c_int()
    rc = _fn("trajio_dcd_info")(path.encode(), ctypes.byref(nf), ctypes.byref(na))
    if rc != 0:
        raise IOError(f"trajio_dcd_info({path}) failed: {rc}")
    out = np.empty((nf.value, na.value, 3), np.float32)
    got = _fn("trajio_dcd_read")(path.encode(), _fptr(out), nf.value)
    if got < 0:
        raise IOError(f"trajio_dcd_read({path}) failed: {got}")
    return out[:got]


def write_dcd(path: str, pos_nm: np.ndarray) -> None:
    pos = _frames(pos_nm)
    rc = _fn("trajio_dcd_write")(path.encode(), _fptr(pos), pos.shape[0], pos.shape[1])
    if rc != 0:
        raise IOError(f"trajio_dcd_write({path}) failed: {rc}")


def read_xtc(path: str) -> np.ndarray:
    nf, na = ctypes.c_int(), ctypes.c_int()
    rc = _fn("trajio_xtc_info")(path.encode(), ctypes.byref(nf), ctypes.byref(na))
    if rc != 0 or nf.value <= 0:
        raise IOError(f"trajio_xtc_info({path}) failed: rc={rc} frames={nf.value}")
    out = np.empty((nf.value, na.value, 3), np.float32)
    got = _fn("trajio_xtc_read")(path.encode(), _fptr(out), nf.value)
    if got <= 0:
        raise IOError(f"trajio_xtc_read({path}) failed: {got}")
    return out[:got]


def write_xtc(path: str, pos_nm: np.ndarray, precision: float = 1000.0) -> None:
    pos = _frames(pos_nm)
    rc = _fn("trajio_xtc_write")(path.encode(), _fptr(pos), pos.shape[0], pos.shape[1], precision)
    if rc != 0:
        raise IOError(f"trajio_xtc_write({path}) failed: {rc}")
