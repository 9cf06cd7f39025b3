"""Build the port's trajio library (`jamun_tpu_torch/csrc/trajio.cpp`, the
DCD and XTC codecs; counterpart of `jamun_tpu/data/build_native.py`):

    python -m jamun_tpu_torch.data.build_native

`g++` compiles the source at first use into `jamun_tpu_torch/_build/`, into
a library named by a hash of the source and the flags, so an edited source
rebuilds and a library is never taken for another. The flags name no host
CPU (no `-march=native`), so a library built on one machine is right on
any x86-64 host. The build writes a temporary file and renames it, so
processes that build at once never load a half-written library. A failed
build raises; there is no codec in Python to fall back on.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

__all__ = ["build", "library_path", "SOURCE", "BUILD_DIR", "FLAGS"]

PKG = Path(__file__).resolve().parents[1]
SOURCE = PKG / "csrc" / "trajio.cpp"
BUILD_DIR = PKG / "_build"
# -ffp-contract=off: one multiply, then the round half away from zero, on
# any compiler and host (the codec's integers must not depend on an FMA)
FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> Path:
    """Where the library of the current source and flags is (or will be)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtrajio_{digest[:16]}.so"


def build(verbose: bool = False) -> Path:
    """The library's path, compiled first unless it exists. Raises
    RuntimeError when there is no g++ or it fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's trajio (DCD/XTC) library builds with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [gxx, *FLAGS, str(SOURCE), "-o", tmp]
    if verbose:
        print(" ".join(cmd))
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(f"built {build(verbose=True)}")
    sys.exit(0)
