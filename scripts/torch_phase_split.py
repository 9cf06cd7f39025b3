"""Where the time of the ConvBlock kernels goes, by phase: the per-layer
kernel (K2, `csrc/conv_block.cu`), the whole-model kernel (K3,
`csrc/e3_stack.cu`), the tiled ConvBlock from the positions (K5,
`csrc/fused_block_tiled.cu`), the dense messages (K8/K9,
`csrc/dense_conv.cu`), the sparse messages (K6, `csrc/nbr_conv.cu`) and the
ConvBlock backward (K4, `csrc/conv_block_bwd.cu`); and where the time of the
two edge-feature kernels goes (K1, `csrc/edge_features.cu`, and K7,
`csrc/nbr_edge_features.cu`).

Run on a machine with an NVIDIA GPU, from the repository root:
    python3 scripts/torch_phase_split.py [--kernels K2,K3,K5,K9,K6,K4,K1,K7] [--time-only]
        [--same-bits PARENT] [--out FILE]

Copies the sources and the headers into `jamun_tpu_torch/_build/
phase_split/` and adds a `clock64()` stamp after every `__syncthreads()` (and
`cluster.sync()`) of every ConvBlock kernel of those sources (of K4 its pair
pass alone), both builds (f32 and bf16), of the pair loop of
`tiled_pairs_mma.cuh` and of the epilogue steps of `conv_block_body.cuh` and
`conv_block_mma.cuh`: thread 0 of each CTA adds the cycles since the
previous stamp to that stamp's slot, and the slots are summed over the CTAs
of five launches. Builds the copies with nvcc beside the real libraries,
loads them into the wrappers, and prints, at the flagship width with random
weights from seed 0 and in bf16 (K5, K9, K6 and K4 also in f32): K2 (hidden
block and projector, 4AA N = 44, G = 256 and 5AA N = 112, G = 128), K3 (4AA
and 2AA N = 19, G = 256), K5 (hidden block and projector at 4AA, at the
N = 256 walk's first frame, G = 64, and at N = 512, G = 16), K9 (hidden
block at 4AA, 5AA and N = 256, G = 16) with K8 at the projector's width
(V = 0, 4AA), K6 (hidden block and projector on `bench.py`'s N = 512, G = 8
chain with the skin-1.0 Verlet list, on the model's edge attributes, A = 64,
and on the edge-features kernel's radial half, A = 32, and at N = 1024,
G = 2 with the list of one forward) and K4 (hidden block and projector at
the training shape, G = 32 graphs of 44 atoms padded to N = 48, and at
N = 112, G = 32): each launch's time (CUDA events, of the stamped build),
the cycles per CTA and each stamp's share, labelled with the line before
it. A stamp's share is the time of thread 0 between two barriers, so it
counts the slowest warp of that step. K4 launches four kernels; a copy with
a CUDA event after each (and no stamps) times them one by one. Then it
times, at the same shapes in bf16, builds that leave out one step (the
message loop, radial layer 2, the message loop's flushes; K4's dh product
and its dW1 sums; their outputs are wrong, their times say what the step
costs) against the real build. The kernels' own builds are untouched. With `--time-only` it times
the real builds alone at the same shapes (20 launches each), builds nothing
else and needs nothing of this script beyond the wrappers and
`chip_smoke.py`: copied into a checkout of another commit, it times that
commit's kernels, so two commits compare in one call (parent, change,
change, parent).

K1 and K7 have no barrier to stamp. For them it prints, at K1's shapes (4AA
N = 44, G = 256; 5AA N = 112, G = 128; the training shape, 32 graphs of 44
atoms padded to N = 48) and K7's (`bench.py`'s N = 512, G = 8 chain with the
skin-1.0 list; the same chain at the last frame of a 101-step cached walk;
N = 1024, G = 2 with the list of one forward; the ragged N = 203 batch with
the skin-1.0 list), both dtypes: the device time alone
(`chip_smoke.device_time_ms`: a spin kernel holds the stream while the host
queues the calls, so the CUDA events bracket back-to-back kernels), the
host's microseconds per wrapper call (no sync), the smoke's `cuda_time_ms`
figure (20 wrapper calls between two events, which reads the host's pace
where a call's host time is longer than its kernel), and the device time of
two builds that leave one step out: stores of a constant (the sh values and
the radial basis not computed) and the arithmetic alone (the values kept
live by a store the data never takes, no output written). With
`--time-only` the device time and the smoke's figure alone. `--same-bits
PARENT` builds the two sources of the checkout at PARENT beside this one's,
runs both on the same inputs at every shape above and prints the number of
output elements whose bits differ. To time another commit, copy this
script and `chip_smoke.py` into its checkout (its own may be older) and run
it there. Prints the card's name and power limit first; exits non-zero
without a card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from jamun_tpu_torch.ops.cuda.build import BUILD_DIR, CSRC, EXTRA_FLAGS, NVCC_FLAGS, _nvcc  # noqa: E402

OUT = BUILD_DIR / "phase_split"
EVENTS = OUT / "events"  # K4's copy with a CUDA event after each launch
SLOTS = 48  # stamp slots; the last holds the CTA count
END = 40  # the slot of each kernel's end
# the sources of each kernel of the split
SOURCES = {"K2": "conv_block", "K3": "e3_stack", "K5": "fused_block_tiled", "K9": "dense_conv",
           "K6": "nbr_conv", "K4": "conv_block_bwd", "K1": "edge_features",
           "K7": "nbr_edge_features"}
# the edge-feature kernels: no barrier to stamp, timed whole
EDGE = ("edge_features", "nbr_edge_features")
EDGE_DIR = OUT / "edge"  # their builds that leave a step out
PARENT_DIR = OUT / "parent"  # the parent checkout's builds of them (--same-bits)
# the kernel functions stamped where a source has others (K4: the pair pass)
STAMPED = {"conv_block_bwd": ("pair_kernel", "pair_mma_kernel")}
# the sources that run the ConvBlock steps of the headers
FORWARD = ("conv_block", "e3_stack", "fused_block_tiled", "dense_conv", "nbr_conv")
# the shared steps stamped in the headers: header -> (tag, first slot,
# functions); a kernel's own stamps take 0..19
HEADER_SLOTS = {
    "tiled_pairs_mma.cuh": ("pairs", 20, ("void pair_loop(",)),
    "conv_block_mma.cuh": ("mma", 30, ("void post_linear(", "void epilogue(")),
    "conv_block_body.cuh": ("body", 36, ("void epilogue(",)),
}
# builds that leave one step out: label -> (the sources it applies to,
# [(text, replacement)]), applied to every copied file that holds the text
# (at least one must)
SKIPS = {
    "without the message loop": (FORWARD, [
        ("if (c < W) mma::messages(", "if (c < 0) mma::messages("),  # tensor-core builds
        ("if (has_c) messages<T>(", "if (false) messages<T>("),  # FMA builds (layer 2 with it)
    ]),
    "without radial layer 2": (FORWARD, [
        ("    radial_layer2(t, b2, W, m0, warp, lane);\n", "\n"),
        ("    for (int k = 0; k < H; ++k) {\n      float4 hv", "    for (int k = 0; k < 0; ++k) {\n      float4 hv"),
    ]),
    "without the message flushes": (FORWARD, [(
        "      if (td != st.cur) {\n        flush(s, st, c, true, nt);\n        st.cur = td;\n      }",
        "      st.cur = td;",
    )]),
    "without the dh product": (("conv_block_bwd",), [
        # the FMA pair pass (both builds before the tensor-core redesign, f32 after it)
        ("for (int cc = 0; cc < W; ++cc) s += dws[", "for (int cc = 0; cc < 0; ++cc) s += dws["),
        # the tensor-core pair pass
        ("for (int k0 = 0; k0 < Wk; k0 += 16) {  // dh", "for (int k0 = 0; k0 < 0; k0 += 16) {  // dh"),
    ]),
    "without the dW1 sums": (("conv_block_bwd",), [
        ("for (int q = 0; q < np; ++q) {\n        // rows NR and NR + 1",
         "for (int q = 0; q < 0; ++q) {\n        // rows NR and NR + 1"),
        ("for (int k0 = 0; k0 < PTM; k0 += 16) {  // dW1", "for (int k0 = 0; k0 < 0; k0 += 16) {  // dW1"),
    ]),
}
# the edge-feature kernels' builds that leave a step out: label ->
# [(text, replacement)], applied to both sources and `edge_tiles.cuh` (each
# must apply to one of them)
EDGE_SKIPS = {
    "stores of a constant": [
        ("sh_component(dy, dist)", "1.0f"),
        ("sh_component(dz, dist)", "1.0f"),
        ("sh_component(dx, dist)", "1.0f"),
        ("radial_at(center, dists[p], step)", "1.0f"),
        ("radial_at(center_of(k, step), dist, step)", "1.0f"),
    ],
    "the arithmetic alone": [
        # the staged rows stay in shared memory; K7's direct stores are guarded
        ("  copy_out(stage, dst, n * ec);",
         "  if (threadIdx.x < n * ec && *(const unsigned char*)(stage + threadIdx.x) == 0x5a)\n"
         "    dst[threadIdx.x] = stage[threadIdx.x];"),
        ("    put_sh((T*)p.sh + slot * 4, sh_component(dy, dist), sh_component(dz, dist),\n"
         "           sh_component(dx, dist));\n    p.mask[slot] = kept ? 1.0f : 0.0f;\n"
         "    p.idx_out[slot] = kept ? nbr : (int64_t)p.N;",
         "    const float acc = sh_component(dy, dist) + sh_component(dz, dist) + sh_component(dx, dist);\n"
         "    if (acc == -7.0f) put_sh((T*)p.sh + slot * 4, acc, acc, acc);\n"
         "    if (acc == -8.0f) p.mask[slot] = kept ? 1.0f : 0.0f;\n"
         "    if (acc == -9.0f) p.idx_out[slot] = kept ? nbr : (int64_t)p.N;"),
        ("  copy_out(stage, rad, n * p.nr);",
         "  if (threadIdx.x < n * p.nr && *(const unsigned char*)(stage + threadIdx.x) == 0x5a)\n"
         "    rad[threadIdx.x] = stage[threadIdx.x];"),
    ],
}
PRELUDE = r"""
#ifndef PHASE_PRELUDE
#define PHASE_PRELUDE
__device__ unsigned long long g_phase[48];
__device__ __forceinline__ long long* phase_slots() { __shared__ long long ph[49]; return ph; }
#define STAMP(k) if (threadIdx.x == 0) { long long* ph_ = phase_slots(); long long t_ = clock64(); \
  ph_[k] += t_ - ph_[48]; ph_[48] = t_; }
#define STAMP_INIT if (threadIdx.x == 0) { long long* ph_ = phase_slots(); \
  for (int i_ = 0; i_ < 48; ++i_) ph_[i_] = 0; ph_[48] = clock64(); }
#define STAMP_FIN __syncthreads(); if (threadIdx.x == 0) { long long* ph_ = phase_slots(); \
  for (int i_ = 0; i_ < 47; ++i_) atomicAdd(&g_phase[i_], (unsigned long long)ph_[i_]); \
  atomicAdd(&g_phase[47], 1ull); }
extern "C" __attribute__((weak)) int phase_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long z[48] = {0};
  cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  return (int)e;
}
// CUDA events between the launches of one wrapper call (K4's kernels): event
// k follows launch k of the source's text; a launch the call skips (the
// other build's) records none and reads -1
static cudaEvent_t g_phase_ev[16];
static int g_phase_hit[16];
static int g_phase_nev = 0;
#define PHASE_EVENT(k, s) if (g_phase_nev > (k)) { cudaEventRecord(g_phase_ev[k], (cudaStream_t)(s)); \
  g_phase_hit[k] = 1; }
extern "C" __attribute__((weak)) int phase_events(int n) {
  for (int k = g_phase_nev; k < n; ++k) cudaEventCreate(&g_phase_ev[k]);
  for (int k = 0; k < 16; ++k) g_phase_hit[k] = 0;
  g_phase_nev = n;
  return (int)cudaGetLastError();
}
extern "C" __attribute__((weak)) int phase_event_ms(float* out) {
  int last = 0;
  for (int k = 0; k < g_phase_nev; ++k) last = g_phase_hit[k] ? k : last;
  cudaError_t e = cudaEventSynchronize(g_phase_ev[last]);
  int prev = 0;
  for (int k = 1; k < g_phase_nev; ++k) {
    out[k - 1] = -1.0f;
    if (g_phase_hit[k]) {
      cudaEventElapsedTime(&out[k - 1], g_phase_ev[prev], g_phase_ev[k]);
      prev = k;
    }
  }
  for (int k = 0; k < 16; ++k) g_phase_hit[k] = 0;
  return (int)e;
}
#endif
"""
KERNEL_RE = re.compile(r"__global__ void __launch_bounds__\(MAX_THREADS(?:, \d+)?\) (\w+)\(")
LAUNCH_RE = re.compile(r"^\s*(\w+)(?:<[^<>]*>)?<<<")


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
        if line.strip().strip("{};"):  # the label skips lines of braces alone
            prev = line
    return src[:i] + "\n".join(out) + src[j:], k


def _with_prelude(src: str) -> str:
    """A source with the stamps' prelude after its last #include (a no-op
    where a header brought it already)."""
    at = src.index("\n", src.rindex("#include")) + 1
    return src[:at] + PRELUDE + src[at:]


def _with_events(src: str) -> tuple:
    """K4's source with a CUDA event before the first launch of each branch
    (one build's launches, then the other's after `} else {`) and after each
    launch of its `launch` function; returns it and the launches' names."""
    i, j = _body(src, src.index("int launch(const Params& p, void* stream)"))
    out, names, first = [], [], True
    for line in src[i:j].split("\n"):
        first = first or (bool(names) and "} else {" in line)
        m = LAUNCH_RE.match(line)
        if m and first:
            first = False
            out.append("  PHASE_EVENT(0, stream)")
        out.append(line)
        if m:
            names.append(m.group(1))
            out.append(f"  PHASE_EVENT({len(names)}, stream)")
    return src[:i] + "\n".join(out) + src[j:], names


def make_copies(names) -> dict:
    """Write the stamped copies of the sources `names`; returns the labels
    of the stamps, keyed 'kernel function:slot' and 'pairs:slot' /
    'mma:slot' / 'body:slot' for the headers' shared steps."""
    OUT.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, OUT / h.name)
    labels = {}
    body = (CSRC / "conv_block_body.cuh").read_text()
    body = body.replace("namespace conv_block {", PRELUDE + "namespace conv_block {", 1)
    (OUT / "conv_block_body.cuh").write_text(body)
    for header, (tag, first, functions) in HEADER_SLOTS.items():
        hdr = (OUT / header).read_text()
        k = first
        for fn in functions:
            hdr, k = _stamp(hdr, fn, k, tag, labels)
        (OUT / header).write_text(hdr)
    for name in names:
        src = _with_prelude((CSRC / f"{name}.cu").read_text())
        for m in KERNEL_RE.finditer(src):
            kernel = m.group(1)
            if kernel not in STAMPED.get(name, (kernel,)):
                continue
            sig = m.group(0)
            src, k = _stamp(src, sig, 0, kernel, labels)
            assert k <= 20, (kernel, k)
            i, _ = _body(src, src.index(sig))
            src = src[:i + 1] + "\n  STAMP_INIT" + src[i + 1:]
            _, j = _body(src, src.index(sig))
            src = src[:j] + f"  __syncthreads();\n  STAMP({END})\n  STAMP_FIN\n" + src[j:]
            labels[f"{kernel}:{END}"] = "the kernel's end"
        (OUT / f"{name}.cu").write_text(src)
    return labels


def make_skips(names) -> dict:
    """Write one directory of unstamped copies per entry of SKIPS that
    applies to one of `names`; returns label -> (directory, its sources)."""
    dirs = {}
    for i, (label, (applies, edits)) in enumerate(SKIPS.items()):
        mine = [n for n in names if n in applies]
        if not mine:
            continue
        d = OUT / f"skip{i}"
        d.mkdir(parents=True, exist_ok=True)
        hits = 0
        for f in (*CSRC.glob("*.cuh"), *(CSRC / f"{n}.cu" for n in mine)):
            src = f.read_text()
            for text, repl in edits:
                hits += src.count(text)
                src = src.replace(text, repl)
            (d / f.name).write_text(src)
        assert hits, label
        dirs[label] = (d, mine)
    return dirs


def make_events(names) -> dict:
    """K4's unstamped copy with a CUDA event around each launch; returns
    source -> the names of its launches (empty without K4)."""
    if "conv_block_bwd" not in names:
        return {}
    EVENTS.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, EVENTS / h.name)
    src, launches = _with_events(_with_prelude((CSRC / "conv_block_bwd.cu").read_text()))
    (EVENTS / "conv_block_bwd.cu").write_text(src)
    return {"conv_block_bwd": launches}


def build(jobs) -> dict:
    """Build the sources of each directory (directory -> names), all at
    once; returns the loaded libraries by (directory, source)."""
    procs = {
        (d, name): subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, []), "-o", str(d / f"{name}.so"),
             str(d / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for d, names in jobs.items() for name in names
    }
    libs = {}
    for (d, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {d / name}.cu:\n{log}")
        libs[d, name] = ctypes.CDLL(str(d / f"{name}.so"))
        for fn, argtypes in (("phase_read", [ctypes.c_void_p]), ("phase_events", [ctypes.c_int]),
                             ("phase_event_ms", [ctypes.c_void_p])):
            if hasattr(libs[d, name], fn):
                getattr(libs[d, name], fn).argtypes = argtypes
                getattr(libs[d, name], fn).restype = ctypes.c_int
    return libs


def use(kernel, lib) -> None:
    """Point a CudaKernel's entries at another build's library."""
    for entry, argtypes in kernel.entries.items():
        f = getattr(lib, entry)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    kernel._lib = lib


def slots(lib) -> list:
    buf = (ctypes.c_ulonglong * SLOTS)()
    assert lib.phase_read(ctypes.addressof(buf)) == 0
    return list(buf)


def make_edge_copies(names, parent, skips: bool) -> dict:
    """With `skips` the edge-feature kernels' builds that leave a step out
    (one directory per entry of EDGE_SKIPS) and, with `parent`, that
    checkout's sources; returns label -> (directory, names)."""
    dirs = {}
    files = [*(f"{n}.cu" for n in EDGE), "edge_tiles.cuh"]
    for i, (label, edits) in enumerate(EDGE_SKIPS.items() if skips else ()):
        d = EDGE_DIR / f"skip{i}"
        d.mkdir(parents=True, exist_ok=True)
        for h in CSRC.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        texts = {f: (CSRC / f).read_text() for f in files}
        for text, repl in edits:
            assert any(text in t for t in texts.values()), (label, text)
            texts = {f: t.replace(text, repl) for f, t in texts.items()}
        for f, t in texts.items():
            (d / f).write_text(t)
        dirs[label] = (d, names)
    if parent:
        csrc = Path(parent) / "jamun_tpu_torch" / "csrc"
        PARENT_DIR.mkdir(parents=True, exist_ok=True)
        for f in (*csrc.glob("*.cuh"), *(csrc / f"{n}.cu" for n in names)):
            shutil.copy(f, PARENT_DIR / f.name)
        dirs["parent"] = (PARENT_DIR, names)
    return dirs


def host_us(fn, calls: int = 200) -> float:
    """The host's microseconds per call of `fn` (no sync inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def walk_end_batch(model, config, dev):
    """`bench.py`'s N = 512, G = 8 chain at the last frame of the 101-step
    cached BAOAB walk of `chip_smoke` phase 3d (skin 1.0, seed 2)."""
    import numpy as np

    import chip_smoke as cs
    from jamun_tpu_torch.models.denoiser import Denoiser
    from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
    from jamun_tpu_torch.sampling.sampler import Sampler
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler

    batch = cs.chain_batch(512, 8, dev)
    cfg = MCMCConfig(delta=0.04, friction=1.0, M=1.0, steps=101, save_every_n_steps=1,
                     score_fn_clip=100.0)
    walk = SingleMeasurementSampler(BAOAB(cfg), cs.SIGMA, neighbor_skin=cs.NBR_SKIN)
    out = Sampler(device=dev).sample(Denoiser(model, config), walk, 1, batch, seed=2)
    last = np.stack([entry["y_traj"][:, cfg.steps - 1] for entry in out[0]])
    return batch.replace_pos(torch.from_numpy(last).to(dev))


def edge_cases(names, models, config, cutoff: float, c_in: float, dev) -> list:
    """(tag, kernel, call) at K1's and K7's shapes, both dtypes; `call()`
    launches the wrapper and returns its outputs."""
    import chip_smoke as cs
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig, normalization_factors
    from jamun_tpu_torch.ops.cuda import edge_features as k1
    from jamun_tpu_torch.ops.cuda import nbr_edge_features as k7
    from jamun_tpu_torch.ops.neighbors import capped_neighbor_lists
    from jamun_tpu_torch.utils.testing import make_test_batch

    dtypes = (torch.bfloat16, torch.float32)
    cases = []
    if "edge_features" in names:
        # the walks' shapes, and the training shape of `chip_smoke` phase 5
        tconfig = DenoiserConfig(max_radius=1.0, average_squared_distance=0.3)
        t_in = normalization_factors(cs.SIGMA, tconfig.average_squared_distance)[0]
        t_cut = Denoiser(models[torch.float32], tconfig).effective_radial_cutoff(cs.SIGMA) / t_in
        for label, kw, scale, cut in (
            ("4AA", dict(num_graphs=256, max_nodes=44, nodes_per_graph=[44] * 256, max_bonds=88,
                         scale=0.35), c_in, cutoff),
            ("5AA", dict(num_graphs=128, max_nodes=112, nodes_per_graph=[112] * 128, max_bonds=224,
                         scale=0.35), c_in, cutoff),
            ("train", dict(num_graphs=32, max_nodes=48, nodes_per_graph=[44] * 32, max_bonds=96),
             t_in, t_cut),
        ):
            b = make_test_batch(**kw, device=dev)
            geo = ((b.pos * scale).contiguous(), b.node_mask, b.bond_src, b.bond_dst, b.bond_mask,
                   cut, 32)
            G, N = b.pos.shape[:2]
            for cdt in dtypes:
                cases.append((f"K1 {label} N={N} G={G} {str(cdt).split('.')[-1]}", k1.KERNEL,
                              lambda geo=geo, cdt=cdt: k1.edge_features(*geo, cdt)))
    if "nbr_edge_features" in names:
        for label, batch, cached in (
            ("N512 cached", cs.chain_batch(512, 8, dev), True),
            ("N512 walk end", walk_end_batch(models[torch.bfloat16], config, dev), True),
            ("N1024", cs.chain_batch(1024, 2, dev), False),
            ("ragged cached", cs.chain_batch(203, 3, dev, [203, 190, 150]), True),
        ):
            pos = (batch.pos * c_in).contiguous()
            list_cutoff = cutoff + cs.NBR_SKIN * c_in if cached else cutoff
            idx, superset, _ = capped_neighbor_lists(pos, batch.node_mask, list_cutoff, 32)
            G, N = pos.shape[:2]
            for cdt in dtypes:
                a = (pos, idx, superset, cutoff, 32, cdt)
                cases.append((f"K7 {label} N={N} G={G} {str(cdt).split('.')[-1]}", k7.KERNEL,
                              lambda a=a: k7.nbr_edge_features(*a)))
    return cases


def edge_split(cases, libs: dict, dirs: dict, time_only: bool, report: dict) -> None:
    """Time each case (device alone, the smoke's figure; unless
    `time_only` also the host's time per call and the builds that leave a
    step out) and, where a parent's build is in `dirs`, count the output
    elements whose bits differ from it."""
    import chip_smoke as cs

    for tag, kernel, call in cases:
        name = kernel.source.stem
        kernel._lib = None  # the real build
        row = dict(device_ms=cs.device_time_ms(call), smoke_ms=cs.cuda_time_ms(call, 20))
        if not time_only:
            row["host_us"] = host_us(call)
            for label, (d, _) in dirs.items():
                if label != "parent":
                    use(kernel, libs[d, name])
                    row[label] = cs.device_time_ms(call)
            kernel._lib = None
        if "parent" in dirs:
            want = call()
            use(kernel, libs[dirs["parent"][0], name])
            got = call()
            kernel._lib = None
            row["differing"] = [cs.bits_differ(g, w) for g, w in zip(got, want)]
            del got, want
        report[tag] = row
        print(f"{tag}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()), flush=True)
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_phase_split: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig, normalization_factors
    from jamun_tpu_torch.models.e3conv import E3Conv
    from jamun_tpu_torch.ops.cuda import conv_block as k2
    from jamun_tpu_torch.ops.cuda import conv_block_bwd as k4
    from jamun_tpu_torch.ops.cuda import dense_conv as k89
    from jamun_tpu_torch.ops.cuda import e3_stack as k3
    from jamun_tpu_torch.ops.cuda import edge_features as k1
    from jamun_tpu_torch.ops.cuda import fused_block_tiled as k5
    from jamun_tpu_torch.ops.cuda import nbr_conv as k6
    from jamun_tpu_torch.ops.cuda import nbr_edge_features as k7
    from jamun_tpu_torch.ops.neighbors import capped_neighbor_lists
    from jamun_tpu_torch.utils.testing import make_test_batch

    args = sys.argv[1:]
    out_path = args[args.index("--out") + 1] if "--out" in args else None
    wanted = args[args.index("--kernels") + 1].split(",") if "--kernels" in args else list(SOURCES)
    edge = [SOURCES[k] for k in wanted if SOURCES[k] in EDGE]
    names = [SOURCES[k] for k in wanted if SOURCES[k] not in EDGE]
    time_only = "--time-only" in args
    parent = args[args.index("--same-bits") + 1] if "--same-bits" in args else None
    print(cs.card_line(), flush=True)
    edge_dirs = make_edge_copies(edge, parent, not time_only) if edge else {}
    libs = build(dict(edge_dirs.values()))
    if not time_only:
        labels = make_copies(names)
        skips = make_skips(names)
        launch_names = make_events(names)
        libs.update(build({OUT: names, EVENTS: list(launch_names), **dict(skips.values())}))
    dev = torch.device("cuda")
    config = DenoiserConfig(max_radius=1.0, average_squared_distance=0.5)
    c_in, _, _, c_noise = normalization_factors(cs.SIGMA, config.average_squared_distance)
    models = {cdt: E3Conv(
        tensor_product="uvu", dtype=cdt, device=dev, seed=0) for cdt in (torch.bfloat16, torch.float32)}
    stack = E3Conv(tensor_product="uvu", dtype=torch.bfloat16, fused_stack=True, device=dev, seed=0)
    for m in (*models.values(), stack):
        m.output_gain.data.fill_(1.0)
        m.requires_grad_(False)
    cutoff = Denoiser(models[torch.float32], config).effective_radial_cutoff(cs.SIGMA) / c_in
    gen = torch.Generator(device=dev).manual_seed(1)
    report = {}

    def measure(tag, kernel, lib, fn, cdt):
        use(kernel, lib)
        ms = cs.cuda_time_ms(fn, 10)
        slots(lib)
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        st = slots(lib)
        total = sum(st[:SLOTS - 1])
        # the kernel function of this build: the tensor-core one in bf16
        # where the source has one, else the one template of both builds
        found = KERNEL_RE.findall((OUT / kernel.source.name).read_text())
        kernels = [k for k in found if ("_mma_kernel" in k) == (cdt == torch.bfloat16)]
        if not any("_mma_kernel" in k for k in found):
            kernels = found

        def label(i):
            for key in (*kernels, "pairs", "mma", "body"):
                if f"{key}:{i}" in labels:
                    return f"{key}: {labels[f'{key}:{i}']}"
            return "?"

        split = {f"{i} {label(i)}": st[i] / total for i in range(SLOTS - 1) if st[i]}
        report[tag] = dict(ms=ms, cycles_per_cta=total / st[SLOTS - 1], ctas=st[SLOTS - 1] // 5,
                           split=split)
        print(f"{tag}: {ms:.4f} ms (stamped build), {total / st[SLOTS - 1]:.0f} cycles per CTA, "
              f"{st[SLOTS - 1] // 5} CTAs per launch", flush=True)
        for k, v in split.items():
            print(f"    {v:.4f}  {k}", flush=True)

    def skipped(tag, kernel, name, fn):
        kernel._lib = None  # the real build
        times = {"the real build": cs.cuda_time_ms(fn, 10)}
        for label, (d, mine) in skips.items():
            if name in mine:
                use(kernel, libs[d, name])
                times[label] = cs.cuda_time_ms(fn, 10)
        kernel._lib = None
        report[tag]["skip_ms"] = times
        print(f"{tag}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()), flush=True)

    def by_launch(tag, kernel, name, fn, reps=20):
        """The time of each launch of one wrapper call (CUDA events between
        them, in the unstamped copy), averaged over `reps` calls."""
        lib = libs[EVENTS, name]
        use(kernel, lib)
        n = len(launch_names[name])
        assert lib.phase_events(n + 1) == 0
        buf, total = (ctypes.c_float * n)(), [0.0] * n
        fn()
        for _ in range(reps):
            fn()
            assert lib.phase_event_ms(ctypes.addressof(buf)) == 0
            total = [t + b for t, b in zip(total, buf)]
        assert lib.phase_events(0) == 0
        kernel._lib = None
        times = {k: t / reps for k, t in zip(launch_names[name], total) if t >= 0}
        report[tag]["launch_ms"] = times
        print(f"{tag}: by launch " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
              flush=True)

    def split(tag, kernel, name, fn, cdt):
        if time_only:
            kernel._lib = None  # the real build
            ms = cs.cuda_time_ms(fn, 20)
            report[f"{tag} {str(cdt).split('.')[-1]}"] = dict(ms=ms)
            print(f"{tag} {str(cdt).split('.')[-1]}: the real build {ms:.4f} ms", flush=True)
            return
        measure(f"{tag} {str(cdt).split('.')[-1]}", kernel, libs[OUT, name], fn, cdt)
        if name in launch_names:
            by_launch(f"{tag} {str(cdt).split('.')[-1]}", kernel, name, fn)
        if cdt == torch.bfloat16:
            skipped(f"{tag} bfloat16", kernel, name, fn)

    def block_weights(model, blk, S, V, cdt):
        conv = blk.Conv_0
        return k2.pack_block_weights(conv.radial_nn, conv._post_linear, blk.IrrepsLinear_1,
                                     blk.IrrepsLinear_0, model.embed_bondedness[0],
                                     model.embed_bondedness[1], S=S, V=V, cdt=cdt)

    def blocks(model):
        return (("hidden", model._HiddenLayer_0.ConvBlock_0, 120, 32), ("projector", model.ConvBlock_0, 56, 0))

    for label, (N, G) in (("4AA", (44, 256)), ("5AA", (112, 128)), ("2AA", (19, 256)), ("N256", (256, 64)),
                          ("N512", (512, 16)), ("N256 G16", (256, 16))):
        if label.startswith("N"):
            batch = cs.tiled_batch(N, G, dev)
        else:
            batch = make_test_batch(num_graphs=G, max_nodes=N, nodes_per_graph=[N] * G,
                                    max_bonds=2 * N, scale=0.35, device=dev)
        pos = (batch.pos * c_in).contiguous()
        if "conv_block" in names and label in ("4AA", "5AA"):
            cdt, model = torch.bfloat16, models[torch.bfloat16]
            geo = (pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask, cutoff, 32)
            ef, bf = k1.edge_features(*geo, cdt)
            for block_name, blk, S, V in blocks(model):
                w = block_weights(model, blk, S, V, cdt)
                x = torch.randn((G, N, S + 3 * V), generator=gen, device=dev).to(cdt)
                a = (x, ef, bf, batch.bond_src, batch.bond_dst, w)
                split(f"K2 {block_name} {label}", k2.KERNEL, "conv_block", lambda: k2.fused_conv_block(*a), cdt)
            del ef, bf
        if "e3_stack" in names and label in ("4AA", "2AA"):
            scaled = batch.replace_pos(pos)
            c_noise_t = torch.full((1,), c_noise, dtype=torch.float32, device=dev)
            nf0 = stack.NoiseConditionalScaling_0(stack.AtomEmbeddingWithResidueInformation_0(scaled),
                                                  c_noise_t)
            sargs = stack._stack_args(scaled, nf0, c_noise_t, cutoff)
            split(f"K3 {label}", k3.KERNEL, "e3_stack", lambda: k3.e3conv_stack(*sargs), torch.bfloat16)
        if "fused_block_tiled" in names and label in ("4AA", "N256", "N512"):
            geo = k5.tiled_geometry_inputs(pos, batch.node_mask, batch.bond_src, batch.bond_dst,
                                           batch.bond_mask, cutoff, 32)
            for cdt, model in models.items():
                for block_name, blk, S, V in blocks(model):
                    w = block_weights(model, blk, S, V, cdt)
                    x = torch.randn((G, N, S + 3 * V), generator=gen, device=dev).to(cdt)
                    split(f"K5 {block_name} {label}", k5.KERNEL, "fused_block_tiled",
                          lambda: k5.fused_block_tiled(x, geo, w), cdt)
        if "dense_conv" in names and label in ("4AA", "5AA", "N256 G16"):
            for cdt, model in models.items():
                for block_name, blk, S, V in blocks(model):
                    if V == 0 and label != "4AA":
                        continue
                    d0, d1 = blk.Conv_0.radial_nn.layer(0), blk.Conv_0.radial_nn.layer(1)
                    x = torch.randn((G, N, S + 3 * V), generator=gen, device=dev).to(cdt)
                    a = (pos, batch.node_mask, x, d0.kernel, d0.bias, d1.kernel, d1.bias,
                         model.embed_bondedness[0], cutoff, S, V)
                    kernel, fn = (k89.K9, k89.fused_uvu_conv_dense) if V else (k89.K8, k89.packed_uvu_conv_dense)
                    split(f"{'K9' if V else 'K8'} {block_name} {label}", kernel, "dense_conv",
                          lambda: fn(*a), cdt)
    if "nbr_conv" in names:
        # K6 on `bench.py`'s chains: N = 512, G = 8 with the skin-1.0 list (the
        # model's attributes, A = 64, and K7's radial half, A = 32), and
        # N = 1024, G = 2 with the list of one forward (A = 64)
        for label, (N, G), cached in (("N512 cached", (512, 8), True), ("N1024", (1024, 2), False)):
            batch = cs.chain_batch(N, G, dev)
            scaled = batch.replace_pos((batch.pos * c_in).contiguous())
            list_cutoff = cutoff + cs.NBR_SKIN * c_in if cached else cutoff
            idx, superset, _ = capped_neighbor_lists(scaled.pos, batch.node_mask, list_cutoff, 32)
            for cdt, model in models.items():
                edges, _ = model._sparse_edges(scaled, cutoff, (idx, superset) if cached else None, True)
                variants = [("A64", edges)]
                if cached:
                    sh, rad, mask, nidx = k7.nbr_edge_features(scaled.pos, idx, superset, cutoff, 32, cdt)
                    variants.append(("A32", dataclasses.replace(
                        edges, sh_nbr=sh, attr_nbr=rad, nbr_mask=mask, nbr_idx=nidx)))
                for variant, ed in variants:
                    for block_name, blk, S, V in blocks(model):
                        x = torch.randn((G, N, S + 3 * V), generator=gen, device=dev).to(cdt)
                        a = blk.Conv_0.nbr_kernel_args(x, ed)
                        split(f"K6 {block_name} {variant} {label}", k6.KERNEL, "nbr_conv",
                              lambda: k6.nbr_uvu_conv(*a), cdt)
    if "conv_block_bwd" in names:
        # K4 on K2's residuals at the training shape (G = 32 graphs of 44
        # atoms, N = 48) and at N = 112, G = 32, as chip_smoke's phase 5
        bconfig = DenoiserConfig(max_radius=1.0, average_squared_distance=0.3)
        bc_in = normalization_factors(cs.SIGMA, bconfig.average_squared_distance)[0]
        bcutoff = Denoiser(models[torch.float32], bconfig).effective_radial_cutoff(cs.SIGMA) / bc_in
        for label, kw in (
            ("train", dict(num_graphs=32, max_nodes=48, nodes_per_graph=[44] * 32, max_bonds=96)),
            ("N112", dict(num_graphs=32, max_nodes=112, nodes_per_graph=[112] * 32, max_bonds=224,
                          scale=0.35)),
        ):
            batch = make_test_batch(**kw, device=dev)
            G, N = batch.pos.shape[:2]
            geo = ((batch.pos * bc_in).contiguous(), batch.node_mask, batch.bond_src, batch.bond_dst,
                   batch.bond_mask, bcutoff, 32)
            for cdt, model in models.items():
                ef, bf = k1.edge_features(*geo, cdt)
                for block_name, blk, S, V in blocks(model):
                    w = block_weights(model, blk, S, V, cdt)
                    x = torch.randn((G, N, S + 3 * V), generator=gen, device=dev).to(cdt)
                    out, agg, deg = k2.fused_conv_block(x, ef, bf, batch.bond_src, batch.bond_dst, w,
                                                        residuals=True)
                    g = torch.randn(out.shape, generator=gen, device=dev)
                    a = (g, x, ef, bf, batch.bond_src, batch.bond_dst, w, agg, deg)
                    split(f"K4 {block_name} {label}", k4.KERNEL, "conv_block_bwd",
                          lambda: k4.conv_block_bwd(*a), cdt)
    if edge:
        edge_split(edge_cases(edge, models, config, cutoff, c_in, dev), libs, edge_dirs, time_only,
                   report)
    for k in (k1.KERNEL, k2.KERNEL, k3.KERNEL, k5.KERNEL, k89.K8, k89.K9, k6.KERNEL, k7.KERNEL,
              k4.KERNEL):
        k._lib = None
    if out_path:
        Path(out_path).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
