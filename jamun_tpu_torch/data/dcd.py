"""Minimal CHARMM/NAMD DCD trajectory reader and writer in numpy (the port's
own copy of `jamun_tpu/data/dcd.py`). Coordinates are stored in Angstrom in
the file and converted to and from nm here.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["read_dcd", "write_dcd"]


def _fort_record(f, payload: bytes):
    n = struct.pack("<i", len(payload))
    f.write(n + payload + n)


def write_dcd(path: str, positions_nm: np.ndarray):
    """positions_nm: [n_frames, n_atoms, 3] in nm."""
    pos = np.asarray(positions_nm, dtype=np.float32) * 10.0  # nm -> Angstrom
    n_frames, n_atoms, _ = pos.shape
    with open(path, "wb") as f:
        header = struct.pack(
            "<4s9if10i",
            b"CORD",
            n_frames,  # NSET
            0,  # ISTART
            1,  # NSAVC
            0, 0, 0, 0, 0,  # 5 zeros
            0,  # NAMNF
            1.0,  # DELTA (float32 here; charmm pads differently but readers accept)
            0, 0, 0, 0, 0, 0, 0, 0, 0,
            24,  # CHARMM version flag
        )
        _fort_record(f, header)
        title = b"Created by jamun_tpu".ljust(80)
        _fort_record(f, struct.pack("<i", 1) + title)
        _fort_record(f, struct.pack("<i", n_atoms))
        for frame in pos:
            for axis in range(3):
                _fort_record(f, frame[:, axis].astype("<f4").tobytes())


def _read_record(f) -> bytes:
    raw = f.read(4)
    if len(raw) < 4:
        return b""
    (n,) = struct.unpack("<i", raw)
    payload = f.read(n)
    f.read(4)
    return payload


def read_dcd(path: str) -> np.ndarray:
    """Returns [n_frames, n_atoms, 3] in nm."""
    with open(path, "rb") as f:
        header = _read_record(f)
        assert header[:4] == b"CORD", "not a DCD file"
        nset = struct.unpack("<i", header[4:8])[0]
        charmm = struct.unpack("<i", header[80:84])[0] != 0
        has_unitcell = charmm and struct.unpack("<i", header[44:48])[0] != 0
        _read_record(f)  # titles
        (n_atoms,) = struct.unpack("<i", _read_record(f))
        frames = []
        while True:
            if has_unitcell:
                rec = _read_record(f)
                if not rec:
                    break
            x = _read_record(f)
            if not x:
                break
            y = _read_record(f)
            z = _read_record(f)
            xyz = np.stack(
                [
                    np.frombuffer(x, dtype="<f4", count=n_atoms),
                    np.frombuffer(y, dtype="<f4", count=n_atoms),
                    np.frombuffer(z, dtype="<f4", count=n_atoms),
                ],
                axis=-1,
            )
            frames.append(xyz)
    return np.stack(frames) / 10.0  # Angstrom -> nm
