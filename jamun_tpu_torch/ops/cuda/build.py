"""Build and load the hand-written CUDA kernels of `jamun_tpu_torch/csrc/`.

Each source compiles with `nvcc` for `sm_90a` into a shared library with a
plain C interface, loaded with `ctypes`, at its first use. Libraries land in
`jamun_tpu_torch/_build/`, named by a hash of the source and of the headers
(`csrc/*.cuh`) beside it, so an edited source or header rebuilds.
`build_all()` starts one `nvcc` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List

from jamun_tpu_torch.utils.trace import span

__all__ = ["CudaKernel", "build_all", "library_path", "BUILD_DIR", "CSRC", "SOURCES"]

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
# every kernel source of the port (K1, K2 and its layer mode, K3, K4, K5, K6,
# K7, K8 and K9, and the Kabsch rotation of training's alignment)
SOURCES = (
    "edge_features", "conv_block", "e3_stack", "conv_block_bwd", "fused_block_tiled",
    "nbr_conv", "nbr_edge_features", "dense_conv", "kabsch",
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
# per source: the edge features keep separate multiplies and adds, so the
# cutoff test sees the same distance as the plain version's
EXTRA_FLAGS = {"edge_features": ["--fmad=false"], "nbr_edge_features": ["--fmad=false"]}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def _flags(source: Path) -> List[str]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(source.stem, [])


def library_path(source: Path) -> Path:
    """Where the library of a kernel source is (or will be) built."""
    text = source.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(_flags(source)).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}_{digest[:16]}.so"


def _start(source: Path):
    """Start nvcc for `source` unless its library exists; returns
    (process or None, temp output, final path)."""
    out = library_path(source)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_flags(source), "-Xptxas", "-v", "-o", tmp, str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(proc, tmp, out: Path) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources (all of them unless told) in parallel;
    returns nvcc's log per name (empty when the library was already built)."""
    names = list(names)
    started = [_start(CSRC / f"{n}.cu") for n in names]
    return {n: _finish(*s) for n, s in zip(names, started)}


class CudaKernel:
    """One kernel of a CUDA source: the source's library (built and loaded at
    first use), the C entry points with their argument types, and the count
    of launches that its wrapper made. Two kernels of one source (`source`
    names it when it differs from `name`) keep separate counts."""

    def __init__(self, name: str, entries: Dict[str, List], source: str = None):
        self.name = name
        self.source = CSRC / f"{source or name}.cu"
        self.entries = entries
        self.launches = 0
        self._lib = None
        self._span = "jamun.kernel:" + name

    def fn(self, entry: str):
        if self._lib is None:
            _finish(*_start(self.source))
            lib = ctypes.CDLL(str(library_path(self.source)))
            for e, argtypes in self.entries.items():
                f = getattr(lib, e)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            self._lib = lib
        return getattr(self._lib, entry)

    def launch(self, entry: str, *args) -> None:
        """Call a C entry point (which launches the kernel on the given stream)
        and count the launch; raises on a CUDA error code. Under a profiler
        the call is the span `jamun.kernel:<name>`."""
        with span(self._span):
            err = self.fn(entry)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}.{entry} failed with CUDA error {err}")
        self.launches += 1
