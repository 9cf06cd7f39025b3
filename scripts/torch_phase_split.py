"""Where the time of the bf16 per-layer and whole-model kernels goes (K2,
`csrc/conv_block.cu`, and K3, `csrc/e3_stack.cu`), by phase.

Run on a machine with an NVIDIA GPU, from the repository root:
    python3 scripts/torch_phase_split.py [--out FILE]

Copies the two sources and the headers into `jamun_tpu_torch/_build/
phase_split/` and adds a `clock64()` stamp after every `__syncthreads()` (and
`cluster.sync()`) of the bf16 kernels and of the epilogue steps of
`conv_block_mma.cuh`: thread 0 of each CTA adds the cycles since the
previous stamp to that stamp's slot, and the slots are summed over the CTAs
of five launches. Builds the copies with nvcc beside the real libraries,
loads them into the wrappers, and prints for K2 (hidden block and
projector, 4AA N = 44, G = 256 and 5AA N = 112, G = 128) and K3 (4AA and
2AA N = 19, G = 256), at the flagship width with random weights from seed
0, each launch's time (CUDA events, of the stamped build), the cycles per
CTA and each stamp's share, labelled with the line before it. A stamp's
share is the time of thread 0 between two barriers, so it counts the
slowest warp of that step. Then it times, at the same shapes, builds that
leave out one step (the message loop, radial layer 2, the message loop's
flushes; their outputs are wrong, their times say what the step costs)
against the real build. The kernels' own builds are untouched. Prints the
card's name and power limit first; exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from jamun_tpu_torch.ops.cuda.build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc  # noqa: E402

OUT = BUILD_DIR / "phase_split"
SLOTS = 32  # stamp slots; the last holds the CTA count
# builds that leave one step of conv_block_mma.cuh out: (text, replacement)
SKIPS = {
    "without the message loop": ("if (c < W) mma::messages(", "if (c < 0) mma::messages("),
    "without radial layer 2": ("    radial_layer2(t, b2, W, m0, warp, lane);\n", "\n"),
    "without the message flushes": (
        "      if (td != st.cur) {\n        flush(s, st, c, true, nt);\n        st.cur = td;\n      }",
        "      st.cur = td;",
    ),
}
PRELUDE = r"""
__device__ unsigned long long g_phase[32];
__device__ __forceinline__ long long* phase_slots() { __shared__ long long ph[33]; return ph; }
#define STAMP(k) if (threadIdx.x == 0) { long long* ph_ = phase_slots(); long long t_ = clock64(); \
  ph_[k] += t_ - ph_[32]; ph_[32] = t_; }
#define STAMP_INIT if (threadIdx.x == 0) { long long* ph_ = phase_slots(); \
  for (int i_ = 0; i_ < 32; ++i_) ph_[i_] = 0; ph_[32] = clock64(); }
#define STAMP_FIN __syncthreads(); if (threadIdx.x == 0) { long long* ph_ = phase_slots(); \
  for (int i_ = 0; i_ < 31; ++i_) atomicAdd(&g_phase[i_], (unsigned long long)ph_[i_]); \
  atomicAdd(&g_phase[31], 1ull); }
extern "C" __attribute__((weak)) int phase_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long z[32] = {0};
  cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  return (int)e;
}
"""


def _body(src: str, start: int) -> tuple:
    """(index of the opening brace, index of the matching closing brace) of
    the function whose signature starts at `start`."""
    i = src.index("{", start)
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return i, j
    raise ValueError("unbalanced braces")


def _stamp(src: str, signature: str, first: int, tag: str, labels: dict) -> tuple:
    """A STAMP after each barrier of the function `signature`, numbered from
    `first`; returns the new source and the next free number."""
    i, j = _body(src, src.index(signature))
    out, k, prev = [], first, ""
    for line in src[i:j].split("\n"):
        out.append(line)
        if "__syncthreads();" in line or "cluster.sync();" in line:
            out.append(f"STAMP({k})")
            labels[f"{tag}:{k}"] = f"after '{prev.strip()[:70]}'"
            k += 1
        if line.strip():
            prev = line
    return src[:i] + "\n".join(out) + src[j:], k


def make_copies() -> dict:
    """Write the stamped copies; returns the labels of the stamps."""
    OUT.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, OUT / h.name)
    labels = {}
    hdr = (CSRC / "conv_block_mma.cuh").read_text()
    hdr = hdr.replace("namespace conv_block {\nnamespace mma {",
                      PRELUDE + "namespace conv_block {\nnamespace mma {", 1)
    hdr, k = _stamp(hdr, "void post_linear(", 20, "mma", labels)
    hdr, _ = _stamp(hdr, "void epilogue(", k, "mma", labels)
    (OUT / "conv_block_mma.cuh").write_text(hdr)
    for name, kernel in (("conv_block", "conv_block_mma_kernel("), ("e3_stack", "e3_stack_mma_kernel(")):
        src = (CSRC / f"{name}.cu").read_text()
        src, k = _stamp(src, f"__global__ void __launch_bounds__(MAX_THREADS) {kernel}", 0, name, labels)
        assert k <= 20, k
        i, _ = _body(src, src.index(f"__global__ void __launch_bounds__(MAX_THREADS) {kernel}"))
        src = src[:i + 1] + "\n  STAMP_INIT" + src[i + 1:]
        _, j = _body(src, src.index(f"__global__ void __launch_bounds__(MAX_THREADS) {kernel}"))
        src = src[:j] + "  __syncthreads();\n  STAMP(30)\n  STAMP_FIN\n" + src[j:]
        labels[f"{name}:30"] = "the kernel's end"
        (OUT / f"{name}.cu").write_text(src)
    return labels


def make_skips() -> dict:
    """Write one directory of unstamped copies per entry of SKIPS."""
    dirs = {}
    for i, (label, (text, repl)) in enumerate(SKIPS.items()):
        d = OUT / f"skip{i}"
        d.mkdir(parents=True, exist_ok=True)
        for f in (*CSRC.glob("*.cuh"), CSRC / "conv_block.cu", CSRC / "e3_stack.cu"):
            src = f.read_text()
            if f.name == "conv_block_mma.cuh":
                assert src.count(text) == 1, label
                src = src.replace(text, repl)
            (d / f.name).write_text(src)
        dirs[label] = d
    return dirs


def build(dirs) -> dict:
    """Build conv_block.cu and e3_stack.cu in each directory, all at once;
    returns the loaded libraries by (directory, source)."""
    procs = {
        (d, name): subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(d / f"{name}.so"), str(d / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for d in dirs for name in ("conv_block", "e3_stack")
    }
    libs = {}
    for (d, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {d / name}.cu:\n{log}")
        libs[d, name] = ctypes.CDLL(str(d / f"{name}.so"))
    for name in ("conv_block", "e3_stack"):
        libs[OUT, name].phase_read.argtypes = [ctypes.c_void_p]
        libs[OUT, name].phase_read.restype = ctypes.c_int
    return libs


def use(kernel, lib) -> None:
    """Point a CudaKernel's entries at the stamped library."""
    for entry, argtypes in kernel.entries.items():
        f = getattr(lib, entry)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    kernel._lib = lib


def slots(lib) -> list:
    buf = (ctypes.c_ulonglong * SLOTS)()
    assert lib.phase_read(ctypes.addressof(buf)) == 0
    return list(buf)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_phase_split: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig, normalization_factors
    from jamun_tpu_torch.models.e3conv import E3Conv
    from jamun_tpu_torch.ops.cuda import conv_block as k2
    from jamun_tpu_torch.ops.cuda import e3_stack as k3
    from jamun_tpu_torch.ops.cuda import edge_features as k1
    from jamun_tpu_torch.utils.testing import make_test_batch

    args = sys.argv[1:]
    out_path = args[args.index("--out") + 1] if "--out" in args else None
    print(cs.card_line(), flush=True)
    labels = make_copies()
    skips = make_skips()
    libs = build([OUT, *skips.values()])
    dev, cdt = torch.device("cuda"), torch.bfloat16
    config = DenoiserConfig(max_radius=1.0, average_squared_distance=0.5)
    c_in, _, _, c_noise = normalization_factors(cs.SIGMA, config.average_squared_distance)
    model = E3Conv(dtype=cdt, device=dev, seed=0)
    stack = E3Conv(dtype=cdt, fused_stack=True, device=dev, seed=0)
    for m in (model, stack):
        m.output_gain.data.fill_(1.0)
        m.requires_grad_(False)
    cutoff = Denoiser(model, config).effective_radial_cutoff(cs.SIGMA) / c_in
    gen = torch.Generator(device=dev).manual_seed(1)
    report = {}

    def measure(tag, kernel, lib, name, fn):
        use(kernel, lib)
        ms = cs.cuda_time_ms(fn, 10)
        slots(lib)
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        st = slots(lib)
        total = sum(st[:SLOTS - 1])
        split = {
            f"{i} {labels.get(f'{name}:{i}') or labels.get(f'mma:{i}')}": st[i] / total
            for i in range(SLOTS - 1) if st[i]
        }
        report[tag] = dict(ms=ms, cycles_per_cta=total / st[SLOTS - 1], split=split)
        print(f"{tag}: {ms:.4f} ms (stamped build), {total / st[SLOTS - 1]:.0f} cycles per CTA", flush=True)
        for k, v in split.items():
            print(f"    {v:.4f}  {k}", flush=True)

    def skipped(tag, kernel, name, fn):
        kernel._lib = None  # the real build
        times = {"the real build": cs.cuda_time_ms(fn, 10)}
        for label, d in skips.items():
            use(kernel, libs[d, name])
            times[label] = cs.cuda_time_ms(fn, 10)
        kernel._lib = None
        report[tag]["skip_ms"] = times
        print(f"{tag}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()), flush=True)

    for label, (N, G) in (("4AA", (44, 256)), ("5AA", (112, 128)), ("2AA", (19, 256))):
        batch = make_test_batch(num_graphs=G, max_nodes=N, nodes_per_graph=[N] * G, max_bonds=2 * N,
                                scale=0.35, device=dev)
        pos = (batch.pos * c_in).contiguous()
        if label != "2AA":
            geo = (pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask, cutoff, 32)
            ef, bf = k1.edge_features(*geo, cdt)
            for block_name, blk, S, V in (("hidden", model._HiddenLayer_0.ConvBlock_0, 120, 32),
                                          ("projector", model.ConvBlock_0, 56, 0)):
                conv = blk.Conv_0
                w = k2.pack_block_weights(conv.radial_nn, conv._post_linear, blk.IrrepsLinear_1,
                                          blk.IrrepsLinear_0, model.embed_bondedness[0],
                                          model.embed_bondedness[1], S=S, V=V, cdt=cdt)
                x = torch.randn((G, N, S + 3 * V), generator=gen, device=dev).to(cdt)
                a = (x, ef, bf, batch.bond_src, batch.bond_dst, w)
                measure(f"K2 {block_name} {label}", k2.KERNEL, libs[OUT, "conv_block"], "conv_block",
                        lambda: k2.fused_conv_block(*a))
                skipped(f"K2 {block_name} {label}", k2.KERNEL, "conv_block", lambda: k2.fused_conv_block(*a))
        if N <= k3.MAX_ATOMS:
            scaled = batch.replace_pos(pos)
            c_noise_t = torch.full((1,), c_noise, dtype=torch.float32, device=dev)
            nf0 = stack.NoiseConditionalScaling_0(stack.AtomEmbeddingWithResidueInformation_0(scaled),
                                                  c_noise_t)
            sargs = stack._stack_args(scaled, nf0, c_noise_t, cutoff)
            measure(f"K3 {label}", k3.KERNEL, libs[OUT, "e3_stack"], "e3_stack",
                    lambda: k3.e3conv_stack(*sargs))
            skipped(f"K3 {label}", k3.KERNEL, "e3_stack", lambda: k3.e3conv_stack(*sargs))
    k2.KERNEL._lib = k3.KERNEL._lib = None
    if out_path:
        Path(out_path).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
