"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the repository root:
    python3 chip_smoke.py [--out FILE]

Phases (any failure exits non-zero; nothing is caught):
  1. build the hand-written kernels from jamun_tpu_torch/csrc/ (one nvcc per
     source, started together), print the card's name and power limit,
     each kernel's registers and spills, and the tensor-core instructions
     (HMMA) of the bf16 kernels of K2, K3, K5, K8/K9, K6 and K4 in the built
     libraries (each must issue some); for K5 and K8/K9, both builds at the
     walks' shapes, the launch shape (dst atoms per CTA, sources per pass of
     the pair list, staged epilogue), registers, spills, CTAs per SM and
     shared bytes, the library's reckoning held to its Python mirror; the
     same for K6 (A = 64 and 32, K = 32 slots) and K4's pair pass (the
     training shape and N = 112), both builds, hidden block and projector,
     and for K1 (4AA, 5AA, the training shape) and K7 (N = 512, 1024 and the
     ragged 203, K = 32): CTAs, edges per tile, shared bytes;
  2. hold each kernel against its plain PyTorch version on the card, at the
     flagship width (hidden 120x0e + 32x1e, projector 56x0e) and the walk's
     shapes, in bf16 and f32, and time kernel and plain version with CUDA
     events: the edge features and the ConvBlock at N = 44, G = 256 and
     N = 112, G = 128; the whole-model kernel at 4AA (N = 44, G = 256), 2AA
     (N = 19, G = 256) and one batch of sizes [44, 41], also against the
     layerwise kernel path on the same weights; the tiled ConvBlock (K5,
     geometry rebuilt from the positions) at N = 256, G = 64 and on a ragged
     batch whose N is no multiple of 8, projector and hidden block, with the
     degree it counted held to its plain version's exactly, and against K2 at
     N = 112 bit for bit in both dtypes; the dense messages from the
     positions (K8 and K9) at the
     hidden width at 4AA, 5AA and N = 256, G = 16, and K8 at the projector's
     width, the degree exactly and K9 equal to K8 bit for bit; K2's layer
     mode on the hidden block's Conv at 4AA and 5AA; the sparse path's
     kernels on `bench.py`'s chain geometry
     (N = 512, G = 8 with the list of one forward and with the skin-1.0
     Verlet list, N = 1024, G = 2, a ragged N = 203): the edge features on a
     cached list (K7), mask and indices exactly, and the messages (K6) for
     the projector and a hidden block, on the model's attributes and on
     K7's radial half (also on the ragged batch with the skin-1.0 list),
     the degree exactly; both once more at the load the cached N = 512 walk
     of phase 3d ends at; K2's, K3's, K6's and K4's rows also give
     registers per thread, CTAs per SM and the time before their
     tensor-core redesign (`PREV_MS`), and the library's shared-memory
     reckoning against its Python mirror; K1's and K7's rows their device
     time alone (`device_time_ms`) beside the time through the wrapper and
     the time before their redesign for the memory path, and K7 against K1
     bit for bit on every kept slot of the 4AA and 5AA lists; the Kabsch
     rotation (Horn's quaternion, `csrc/kabsch.cu`) against its plain
     version and the SVD alignment at G = 32, N = 48 (random, mirrored,
     near-planar and single-atom graphs), with no host wait;
  3. drive the main paths at full flagship width with random weights from a
     seed, launch counts zeroed just before each and read just after:
     (a) the stack path through the sampling loop, `Sampler.sample` ->
     `SingleMeasurementSampler` -> BAOAB -> `Denoiser.score` ->
     `E3Conv(fused_stack=True)` -> the whole-model kernel: 4AA and 2AA,
     G = 256, two continued batches of 101 steps, then a short ABOBA walk
     (unfused jump) and a chunked host-offload walk; K3 must launch once per
     denoiser call and K1 and K2 not at all;
     (b) the layerwise path, E3Conv -> Denoiser.score -> BAOAB walk -> fused
     jump: 4AA (N = 44, G = 256, 101 steps, the comparison) and 5AA (N = 112,
     G = 128, 101 steps, beyond the whole-model kernel); K1 once and K2 six
     times per score call, K3 not at all;
     (c) the dense path above 128 atoms through `Sampler.sample`: N = 256,
     G = 64, 101 BAOAB steps, and a shorter walk at N = 512, G = 16 with
     `neighbor_mode="dense"`; K5 six times per denoiser call, K1, K2 and K3
     not at all; the peak device memory of the N = 256 walk must stay below
     what one [G, N, N, 36] bf16 tensor would take;
     (d) the sparse path through `Sampler.sample` with the default
     `neighbor_mode="auto"`: N = 512, G = 8, 101 BAOAB steps on Verlet
     lists (`neighbor_skin=1.0`) with `nbr_geom_kernel` off and on, and
     N = 1024, G = 2, 101 steps with the list of each forward; K6 six times
     per denoiser call, K7 once per cached score call of the
     `nbr_geom_kernel` walk and never otherwise, K1, K2, K3, K5 never; the
     rebuild count, one list build timed, the overflow `Sampler` reported,
     the kept slots and one score call on the first and the last frame;
     (e) walk-jump with `E3Conv(pallas_variant="plane")` through
     `Sampler.sample`, BAOAB, 101 steps at 4AA (N = 44, G = 256) and 5AA
     (N = 112, G = 128): K9 five times per denoiser call (the projector, at
     V = 0, runs the plain path), every other kernel never;
     (f) `Conv` calls that reach K8 (irreps_out 32x1e at the hidden width;
     V = 0 without the bondedness-1 row) and K2's layer mode, with their
     launch counts, against the plain path on the card;
  4. check the output: finite, the expected shape, both kernel paths' f32
     score against the CPU plain path on a small input, and E(3)
     equivariance of both, the same for the K5 path at N = 256, for the
     sparse path (K6) at N = 512, G = 2 and for the plane path (K9); a short
     walk on each path with PyTorch's sync debug mode set to raise (no step
     waits for the device), the sparse path's cached and uncached walks and
     the plane walk included, and three `Trainer.fit` steps from host
     batches with a mirror flip, a fixed noise draw and the default Kabsch
     alignment (one Kabsch launch per step); torch.profiler
     traces of a short 4AA walk on each path (device time by kernel, device
     busy share, device ops per forward), the N = 256 walk, the cached
     N = 512 sparse walk and the plane walk included;
  5. training: K4 (the ConvBlock backward) against its plain version for
     the projector and a hidden block at the training shape (G = 32, N = 48,
     44 atoms) and at N = 112 (G = 32), bf16 and f32, timed; then the second
     main path, a 20-step `Trainer.fit` of the flagship in bf16 (seed 0, lr
     2e-3, ConstantSigma(0.04), one fixed noise draw) with one EMA
     validation, launch counts
     zeroed before and read after (K1 once and K2 six times per forward, K4
     six times per step, the Kabsch kernel once per aligned batch, the
     validation's included), finite and falling loss; then the f32 gradients of
     `training_loss` on the card's kernel path against the CPU plain path;
     then training above 128 atoms: a few `Trainer.fit` steps at N = 256,
     G = 4 in bf16, which take the plain path on the card (every kernel's
     launch count stays 0), with ms/step and peak memory, and an EMA
     validation, which takes K5; then a few `Trainer.fit` steps with the
     default "auto" at N = 256, G = 4 (chain positions), which take the
     plain sparse path (every launch count 0, a finite loss, the cap's
     overflow logged);
  6. the training CLI, `jamun_tpu_torch.cmdline.train.main`, in process on a
     4AA dataset written by `build_peptide` (four uncapped tetrapeptides for
     training, two for validation, 200 frames each: the structure plus
     N(0, 0.02 nm) noise; every graph pads to the 48-atom bucket):
     `experiment=train_uncapped_4AA` for 30 steps, validating every 15, at
     the repo's full width (uvw, 120x0e + 32x1e, 5 layers, batch 32), then
     the same with `model/arch=e3conv_separable` (uvu, bf16, kernels on).
     Launch counts zeroed before each run and read after: K1, K2 and K4
     launch in the separable run and none of them in the uvw run; the Kabsch
     kernel in both (the alignment is on). Each run: ms/step (the median
     gap between consecutive logged steps outside the profiled ones, each
     logged read a synchronize),
     peak device memory, first and last train loss and the val losses,
     finite and falling, the device-busy share of the CLI's own steps 19-28
     under torch.profiler (its fit's host work between steps included), and
     its trained weights' f32 score on the card against the CPU plain path
     (1e-3 of the max). Then `restore_checkpoint` of the uvw run's last.ckpt
     equals the saved parameters, EMA, optimizer state and generators bit for
     bit, and `resume_from_checkpoint` trains it 5 steps on: the step count
     carries on and the manifest lists the top k;
  7. the sample CLI, `jamun_tpu_torch.cmdline.sample.main`, in process on
     phase 6's run directories (the same work directory, `cli_workdir`):
     `experiment=sample_uncapped_4AA` with `init_datasets.root` at the 4AA
     validation split (two tetrapeptides, the 48-atom bucket), each run with
     its own `checkpoint_dir` and `output_dir`, widths the runs' own, only
     run lengths and chain counts cut (`SAMPLE_RUNS`): the separable run
     (uvu, bf16) on the stack path, 32 chains per peptide (G = 64), 3
     batches of 500 steps, every 5th frame saved (K3 once per denoiser
     call, every other kernel never); the same finetuned first for 5 steps
     on its starting frames (`finetune_on_init`), 2 batches of 100 (K1 once
     and K2 six times per forward, K4 six times and the Kabsch kernel once
     per finetune step, K3 never; finite losses, the EMA moved); the uvw run
     (f32), G = 8, 2 batches of 50 (no kernel); and the separable
     checkpoint written again in flax's msgpack layout
     (`write_flax_checkpoint`, JAX's `save_checkpoint` format), one batch
     from it, whose EMA score on three fixed frames, parameters, EMA, Adam
     state and step equal the torch file's bit for bit. Launch counts are
     zeroed before each run and read after, and denoiser calls counted
     (`count_forwards`). Each run: JAX's sampler layout on disk (frames =
     chains x batches x saved frames; the joined trajectory read back
     through `load_run_trajectory` equals the `.npy` batches), finite
     Ramachandran JSD and sliced Wasserstein, validity rates in [0, 1],
     finite score-norm statistics, the CSV's rows (the warm rate without
     batch 0, the rate with it), warm ms/sample and ms/step, host seconds
     in the metrics (`time_metrics`), peak device memory;
  8. the IDRome regime through the CLIs at full width (`idrome_runs`): an
     IDRome-layout tree written with the port's `write_xtc`
     (`<data>/IDRome_v4_preprocessed/all_atom_relaxed_combined/<name>/
     {traj.xtc,top.pdb}`, two `build_peptide` chains of disordered-region
     sequences, 600 and 1105 heavy atoms, buckets 1024 and 2048, hydrogens
     in `top.pdb`, 200 frames of N(0, 0.02 nm) noise) and a CA-bead tree in
     `.dcd` (`idrome_cg/{train,val}`, 82-120 beads); `train_idrome` with
     `model/arch=e3conv_separable` (the plain sparse training path, batch
     32, K6 in the validation) and with its uvw arch (batch cut to 1: 45 GiB
     a graph at N = 2048), `train_idrome_cg` (separable, the atom-only
     embedding, K1, K2 and K4), each 6 steps and 4 validation batches, with
     ms/step, peak memory, losses and launch counts (exactly the kernels of
     each path, the Kabsch kernel once per batch); `sample_idrome` on the
     separable run, one chain per protein (G = 2, N = 2048), 2 x 200 steps
     on the config's skin-1.0 Verlet lists, with `nbr_geom_kernel` off and
     on (K6 six times per denoiser call, K7 once per cached call where on,
     nothing else), with ms/step, the CSV's warm ms/sample, the rebuilds,
     the kept slots at the last frame and the host metrics' seconds;
     `analysis_sweep` of the samples against the `.xtc` references (no
     `error` label, every label's TICA and MSM JSDs finite); then K1, K2
     and K4 against their plain versions on the beads' training batch and
     K6 and K7 at the walk's last frame;
  9. run between phases 7 and 8, in phase 6's work directory: Ophiuchus
     (`experiment=train_uncapped_4AA model/arch=ophiuchus`: 64x0e + 64x1e,
     4 layers, mul_factor 64, edge_attr_dim 8, uvw, f32, batch 32) through
     the train CLI, 30 steps validating every 15 (finite, falling losses,
     K1-K9 never, the Kabsch kernel per batch; ms/step, peak memory; its f32
     score on the card against the CPU's, 1e-3, and its E(3) error on the
     card, 1e-3 of the output's max); the sample CLI on that run
     (`sample_uncapped_4AA`, 4 chains per peptide, 2 x 100 steps, no
     kernel) and a profiled 6-step walk of its sampling model (device busy
     share, device ops per forward); `batch_sampler=vesde` at the config's N = 1000 steps, one
     batch of 4 chains per peptide, on phase 6's separable run (K3 once per
     denoiser call, nothing else) and on the Ophiuchus run (no kernel), its
     trajectories [N, G, N_atoms, 3] as JAX's and its sample finite; and
     `UnrolledBAOAB` on the stack path (4AA, G = 256, 101 steps in chunks
     of 25: K3 once per update and once per chunk), its frames held against
     `BAOAB`'s on the same generator (the differing bits and the largest
     difference printed);
 10. after phase 9, in phase 6's work directory, the rest of the
     equivariant-ops library, none of which reaches a TPU kernel in JAX:
     (a) `experiment=train_uncapped_4AA model.arch.tensor_product=
     experimental` (120x0e + 32x1e, 5 layers, f32, batch 32) through the
     train CLI, 20 steps validating once, then the sample CLI on it (4
     chains per peptide, 2 x 100 steps); (b) `model/arch=e3conv_separable`
     with SH `1x0e + 1x1e + 1x2e` and hidden `120x0e + 32x1e + 16x2e` (bf16),
     20 steps, then a 50-step BAOAB walk of its EMA model at G = 8 through
     the sample CLI; for each run finite, falling losses (the mean of steps
     16-20 below that of 1-5), K1-K9 never (the structural gate), the
     Kabsch kernel per training batch, ms/step, peak memory, its f32 score
     on the card against the CPU's and its E(3) error on the card, of the
     output and of the last hidden layer's features under the port's
     Wigner D (1e-3 each), and a profiled 6-step walk of each sampling
     model (device busy share); (c) `TransformerBlock` (120x0e + 32x1e, 4
     heads), `Equiformer` and `Convnet` (32 channels) forward and backward
     on the 4AA training batch (G = 32, N = 48): ms, peak memory, card
     against CPU on 4 graphs (outputs and gradients, 1e-3), E(3) error on
     the card (1e-3), K1-K9 never.
`--out FILE` writes every number as JSON. An earlier line is a JSON object
{"kabsch": {...}} (that kernel replaces no TPU kernel); the line before the
last is a JSON object of per-kernel numbers; the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SIGMA = 0.04
TOL = {  # max |kernel - plain| / max |plain|, per compute dtype
    # f32: the same arithmetic in another summation order
    torch.float32: 1e-4,
    # bf16: the same rounding points, but an f32 sum that differs in its
    # last bits can round h, w or an aggregate to the neighbouring bf16
    # value (relative step 2^-8); a few such flips stay well under 3e-2
    torch.bfloat16: 3e-2,
}
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense tensor-core bf16; f32 FMA
# K2's, its layer mode's and K3's times before their tensor-core redesign
# (ms; PERF.md section 6, from this script's run on NVIDIA H100 80GB HBM3,
# 700.00 W), keyed by (kernel, row shape)
PREV_MS = {
    ("conv_block", "projector 4AA N=44 G=256 bfloat16"): 0.5349,
    ("conv_block", "hidden 4AA N=44 G=256 bfloat16"): 1.3597,
    ("conv_block", "projector 4AA N=44 G=256 float32"): 0.5603,
    ("conv_block", "hidden 4AA N=44 G=256 float32"): 1.3777,
    ("conv_block", "projector 5AA N=112 G=128 bfloat16"): 1.1225,
    ("conv_block", "hidden 5AA N=112 G=128 bfloat16"): 2.8542,
    ("conv_block", "projector 5AA N=112 G=128 float32"): 1.1889,
    ("conv_block", "hidden 5AA N=112 G=128 float32"): 2.8933,
    ("conv_layer", "K2 layer hidden 4AA N=44 G=256 bfloat16"): 1.1410,
    ("conv_layer", "K2 layer hidden 4AA N=44 G=256 float32"): 1.1518,
    ("conv_layer", "K2 layer hidden 5AA N=112 G=128 bfloat16"): 2.5732,
    ("conv_layer", "K2 layer hidden 5AA N=112 G=128 float32"): 2.6277,
    ("e3_stack", "4AA N=44 G=256 bfloat16"): 6.9016,
    ("e3_stack", "4AA N=44 G=256 float32"): 6.8615,
    ("e3_stack", "2AA N=19 G=256 bfloat16"): 2.0853,
    ("e3_stack", "2AA N=19 G=256 float32"): 2.0269,
    # K5's and K8/K9's bf16 rows before their tensor-core redesign (PERF.md
    # section 6: the FMA builds' times from this script's earlier runs)
    ("fused_block_tiled", "hidden N256 N=256 G=64 bfloat16"): 1.9695,
    ("fused_block_tiled", "hidden N512 N=512 G=16 bfloat16"): 1.1273,
    ("packed_uvu_conv_dense", "K8 hidden 4AA N=44 G=256 bfloat16"): 0.6605,
    ("packed_uvu_conv_dense", "K8 projector 4AA N=44 G=256 bfloat16"): 0.2649,
    ("packed_uvu_conv_dense", "K8 hidden 5AA N=112 G=128 bfloat16"): 1.7888,
    ("packed_uvu_conv_dense", "K8 projector 5AA N=112 G=128 bfloat16"): 0.6813,
    ("packed_uvu_conv_dense", "K8 hidden N256 N=256 G=16 bfloat16"): 0.3795,
    ("fused_uvu_conv_dense", "K9 hidden 4AA N=44 G=256 bfloat16"): 0.6479,
    ("fused_uvu_conv_dense", "K9 hidden 5AA N=112 G=128 bfloat16"): 1.7957,
    ("fused_uvu_conv_dense", "K9 hidden N256 N=256 G=16 bfloat16"): 0.3666,
    # K6's and K4's bf16 rows before their tensor-core redesign (PERF.md
    # section 6: the FMA builds' times from this script's run on the
    # committed files before it)
    ("nbr_conv", "projector A64 N512 N=512 G=8 bfloat16"): 0.2401,
    ("nbr_conv", "hidden A64 N512 N=512 G=8 bfloat16"): 0.2806,
    ("nbr_conv", "projector A64 N512 cached N=512 G=8 bfloat16"): 0.2361,
    ("nbr_conv", "hidden A64 N512 cached N=512 G=8 bfloat16"): 0.2799,
    ("nbr_conv", "projector A32 N512 cached N=512 G=8 bfloat16"): 0.2097,
    ("nbr_conv", "hidden A32 N512 cached N=512 G=8 bfloat16"): 0.2485,
    ("nbr_conv", "projector A64 N1024 N=1024 G=2 bfloat16"): 0.2380,
    ("nbr_conv", "hidden A64 N1024 N=1024 G=2 bfloat16"): 0.2202,
    ("nbr_conv", "projector A64 ragged N=203 G=3 bfloat16"): 0.1056,
    ("nbr_conv", "hidden A64 ragged N=203 G=3 bfloat16"): 0.0990,
    ("nbr_conv", "projector A64 N512 walk end N=512 G=8 bfloat16"): 0.4349,
    ("nbr_conv", "hidden A64 N512 walk end N=512 G=8 bfloat16"): 0.7467,
    ("nbr_conv", "projector A32 N512 walk end N=512 G=8 bfloat16"): 0.3397,
    ("nbr_conv", "hidden A32 N512 walk end N=512 G=8 bfloat16"): 0.6446,
    ("conv_block_bwd", "projector train N=48 G=32 bfloat16"): 0.7477,
    ("conv_block_bwd", "hidden train N=48 G=32 bfloat16"): 0.9681,
    ("conv_block_bwd", "projector N112 N=112 G=32 bfloat16"): 1.6731,
    ("conv_block_bwd", "hidden N112 N=112 G=32 bfloat16"): 2.4849,
    # K1's and K7's bf16 rows before their redesign for the memory path
    # (PERF.md section 6: this script's `cuda_time_ms` figure before it,
    # through the wrapper)
    ("edge_features", "4AA N=44 G=256 bfloat16"): 0.1530,
    ("edge_features", "5AA N=112 G=128 bfloat16"): 0.4326,
    ("nbr_edge_features", "N512 cached N=512 G=8 bfloat16"): 0.0626,
}
# the same rows' device time alone before the redesign (PERF.md section 6:
# `scripts/torch_phase_split.py --time-only` on the committed files before
# it, `device_time_ms`, NVIDIA H100 80GB HBM3, 700.00 W)
PREV_DEVICE_MS = {
    ("edge_features", "4AA N=44 G=256 bfloat16"): 0.1487,
    ("edge_features", "5AA N=112 G=128 bfloat16"): 0.4313,
    ("nbr_edge_features", "N512 cached N=512 G=8 bfloat16"): 0.0567,
}


def fit_batches(den, dev, train, val=(), **config):
    """`Trainer.fit` on fixed batches: Adam at lr 2e-3, ConstantSigma(0.04),
    seed 0, checkpoints in a temporary directory. Returns the final state
    and every logged (step, metrics)."""
    from jamun_tpu_torch.train.distributions import ConstantSigma
    from jamun_tpu_torch.train.loop import Trainer, TrainerConfig
    from jamun_tpu_torch.train.optim import adam
    from jamun_tpu_torch.utils.testing import FixedBatches, RecordingLogger

    rec = RecordingLogger()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainerConfig(seed=0, checkpoint_dir=os.path.join(tmp, "checkpoints"), **config)
        state = Trainer(cfg, rec, device=dev).fit(
            den, adam(2.0e-3), ConstantSigma(SIGMA), FixedBatches(list(train), list(val))
        )
    return state, rec.metrics


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_ms(fn, reps: int = 50) -> float:
    """The device time per call of `fn` alone: a spin kernel holds the stream
    while the host queues `reps` calls, so the CUDA events bracket
    back-to-back kernels, not the host's pace (`cuda_time_ms` reads the
    host's time per call where it is the longer). Raises if the spin ended
    before the host had queued every call, four times over."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spun = torch.cuda.Event()
    cycles = 40_000_000  # about 20 ms at the H100's clock
    for _ in range(4):
        torch.cuda._sleep(cycles)
        spun.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not spun.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("device_time_ms: the host did not queue the calls while the stream was held")


def prev_times(row: dict) -> tuple:
    """K1's and K7's log: the row's times before the redesign, through the
    wrapper and on the device alone, each beside its own measure."""
    prev = f" (before the redesign: {row['prev_ms']:.4f})" if row["prev_ms"] else ""
    prev_dev = f" (before: {row['prev_device_ms']:.4f})" if row["prev_device_ms"] else ""
    return prev, prev_dev


def bits_differ(got: torch.Tensor, want: torch.Tensor) -> int:
    """The elements of two tensors of one dtype whose bits differ."""
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    if got.dtype in ints:
        got, want = got.contiguous().view(ints[got.dtype]), want.contiguous().view(ints[want.dtype])
    return int((got != want).sum())


def rel_err(got: torch.Tensor, want: torch.Tensor):
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / max(want.float().abs().max().item(), 1e-30)


def ef_bytes(ef: torch.Tensor, n_dense: int) -> int:
    """The bytes of ef that a kernel visiting only the pairs inside the
    cutoff must read: one 32-byte sector for each other pair's flag, the
    whole row of each visited pair."""
    pairs = ef[..., 0].numel()
    return (pairs - n_dense) * 32 + n_dense * ef.shape[-1] * ef.element_size()


def tensor_core_counts(kernels) -> dict:
    """Phase 1: the HMMA/HGMMA instructions of each kernel function in the
    built libraries of K2, K3, K5, K8/K9, K6 and K4 (`cuobjdump -sass`);
    every library has bf16 kernels (`*_mma_kernel`) and each must issue
    some."""
    from jamun_tpu_torch.ops.cuda.build import library_path

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for kernel in kernels:
        sass = subprocess.run([cuobjdump, "-sass", str(library_path(kernel.source))],
                              check=True, capture_output=True, text=True).stdout
        fn, mine = None, {}
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                mine[fn] = 0
            elif fn is not None and ("HMMA" in line or "HGMMA" in line):
                mine[fn] += 1
        mma = {f: n for f, n in mine.items() if "_mma_kernel" in f}
        assert mma and all(mma.values()), (kernel.source.name, mine)
        counts.update(mine)
    for fn, n in counts.items():
        log(f"phase 1: {n:4d} HMMA/HGMMA in {fn[:100]}")
    # K2's block and layer modes, K3, K5, the dense messages (K8/K9), K6 at
    # A = 64 and 32, and K4's node pass, row products and pair pass
    assert sum("_mma_kernel" in fn for fn in counts) == 10, sorted(counts)
    return counts


def tiled_launch_shapes(k5, k89) -> dict:
    """Phase 1: how K5 and the K8/K9 kernel launch at the walks' shapes
    (flagship width, two bonds per atom), both builds: the library's own
    reckoning (`occupancy`: threads, shared bytes, registers, spills, CTAs
    per SM, dst atoms per CTA, sources per pass, staged epilogue), its
    shared bytes and launch shape held to the Python mirror (`layout`)."""
    out = {}
    for cdt in (torch.bfloat16, torch.float32):
        dt = str(cdt).split(".")[-1]
        for N in (44, 112, 256, 512):
            for block, S, V in (("hidden", 120, 32), ("projector", 56, 0)):
                occ = k5.occupancy(N, 2 * N, S, V, 120, 32, cdt)
                mirror = k5.layout(N, 2 * N, S, V, 120, 32, cdt)
                assert all(occ[k] == v for k, v in mirror.items()), (N, block, dt, occ, mirror)
                out[f"K5 {block} N={N} {dt}"] = occ
                log(f"phase 1: K5 {dt} {block} N={N} B={2 * N}: {occ}")
        for N in (44, 112, 256):
            for block, S, V in (("hidden", 120, 32), ("projector", 56, 0)):
                occ = k89.occupancy(N, S, V, cdt)
                mirror = k89.layout(N, S, V, cdt)
                assert all(occ[k] == v for k, v in mirror.items()), (N, block, dt, occ, mirror)
                out[f"K8/K9 {block} N={N} {dt}"] = occ
                log(f"phase 1: K8/K9 {dt} {block} N={N}: {occ}")
    return out


def sparse_bwd_launch_shapes(k6, k4) -> dict:
    """Phase 1: how K6 (A = 64 and 32, K = 32 slots) and K4's pair pass (the
    training shape N = 48 and N = 112, two bonds per atom) launch, both
    builds, hidden block and projector: the library's own reckoning
    (`occupancy`: threads, shared bytes, registers, spills, CTAs per SM,
    atoms per CTA) held to the Python mirror (`layout`, `pair_layout`)."""
    out = {}
    for cdt in (torch.bfloat16, torch.float32):
        dt = str(cdt).split(".")[-1]
        for block, S, V in (("hidden", 120, 32), ("projector", 56, 0)):
            for A in (64, 32):
                occ = k6.occupancy(A, 32, S, V, cdt)
                mirror = k6.layout(A, 32, S, V, cdt)
                assert all(occ[k] == v for k, v in mirror.items()), (A, block, dt, occ, mirror)
                out[f"K6 {block} A={A} {dt}"] = occ
                log(f"phase 1: K6 {dt} {block} A={A} K=32: {occ}")
            for N in (48, 112):
                occ = k4.occupancy(N, 2 * N, S, V, cdt)
                mirror = k4.pair_layout(N, 2 * N, S, V, cdt)
                assert all(occ[k] == v for k, v in mirror.items()), (N, block, dt, occ, mirror)
                out[f"K4 pair pass {block} N={N} {dt}"] = occ
                log(f"phase 1: K4 pair pass {dt} {block} N={N} B={2 * N}: {occ}")
    return out


def edge_launch_shapes(k1, k7) -> dict:
    """Phase 1: how K1 (4AA, 5AA and the training shape, two bonds per
    atom) and K7 (the N = 512, G = 8 and N = 1024, G = 2 chains and the
    ragged N = 203, G = 3 batch, K = 32 slots) launch, both builds: the
    library's own reckoning (`occupancy`: threads, shared bytes, registers,
    spills, CTAs per SM, edges or slots in the largest tile, rows per tile,
    CTAs) held to the Python mirror (`layout`)."""
    out = {}
    for cdt in (torch.bfloat16, torch.float32):
        dt = str(cdt).split(".")[-1]
        for G, N, B in ((256, 44, 88), (128, 112, 224), (32, 48, 96)):
            occ, mirror = k1.occupancy(G, N, B, 32, cdt), k1.layout(G, N, B, 32, cdt)
            assert all(occ[k] == v for k, v in mirror.items()), (G, N, dt, occ, mirror)
            out[f"K1 N={N} G={G} {dt}"] = occ
            log(f"phase 1: K1 {dt} N={N} G={G} B={B}: {occ}")
        for G, N in ((8, 512), (2, 1024), (3, 203)):
            occ, mirror = k7.occupancy(G, N, 32, 32, cdt), k7.layout(G, N, 32, 32, cdt)
            assert all(occ[k] == v for k, v in mirror.items()), (G, N, dt, occ, mirror)
            out[f"K7 N={N} G={G} {dt}"] = occ
            log(f"phase 1: K7 {dt} N={N} G={G} K=32: {occ}")
    return out


def check_nbr_against_dense(k1, k7, batches: dict, dev, c_in: float, cutoff: float) -> dict:
    """Phase 2: K7 against K1 on the same pairs, bit for bit, in both dtypes:
    on the 4AA and 5AA batches with their capped lists (K = 32, the true
    cutoff), every kept slot (g, i, k) with source j must have
    sh[..., 1:4] == ef[g, i, j, 0:3], radial == ef[g, i, j, 4:] and K1's
    adjacency set. Returns the kept slots and the differing values."""
    from jamun_tpu_torch.ops.neighbors import capped_neighbor_lists

    out = {}
    for label in ("4AA", "5AA"):
        batch = batches[label]
        G, N = batch.pos.shape[:2]
        pos = (batch.pos * c_in).contiguous()
        idx, superset, _ = capped_neighbor_lists(pos, batch.node_mask, cutoff, 32)
        for cdt in (torch.bfloat16, torch.float32):
            tag = f"{label} N={N} G={G} {str(cdt).split('.')[-1]}"
            ef, _ = k1.edge_features(pos, batch.node_mask, batch.bond_src, batch.bond_dst,
                                     batch.bond_mask, cutoff, 32, cdt)
            sh, rad, mask, nidx = k7.nbr_edge_features(pos, idx, superset, cutoff, 32, cdt)
            kept = mask > 0
            g, i, _ = kept.nonzero(as_tuple=True)
            pair = ef[g, i, nidx[kept]]
            differ = dict(sh=bits_differ(sh[kept][:, 1:4], pair[:, 0:3]),
                          radial=bits_differ(rad[kept], pair[:, 4:]),
                          adjacency=int((pair[:, 3] != 1).sum()))
            assert not any(differ.values()), f"K7 against K1 {tag}: {differ} values differ"
            out[tag] = dict(kept=int(g.numel()), **differ)
            log(f"phase 2: K7 against K1 {tag}: sh and radial bit for bit on all {g.numel()} kept "
                f"slots, each an adjacent pair of K1's")
            del ef, sh, rad, mask, nidx, pair
    return out


def covariance(y: torch.Tensor, x: torch.Tensor, node_mask: torch.Tensor):
    """`kabsch_align`'s masked centroids and 3 x 3 covariances: (H, x_mu, y_mu, m)."""
    m = node_mask[..., None].to(y.dtype)
    count = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    x_mu = (x * m).sum(dim=1, keepdim=True) / count
    y_mu = (y * m).sum(dim=1, keepdim=True) / count
    return torch.einsum("gni,gnj->gij", (y - y_mu) * m, (x - x_mu) * m), x_mu, y_mu, m


def svd_aligned(y: torch.Tensor, x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """`kabsch_align` with the SVD's rotation (`ops.geometry.svd_rotation`),
    on whatever device the inputs are: the Kabsch kernel's reference."""
    from jamun_tpu_torch.ops.geometry import svd_rotation

    H, x_mu, y_mu, m = covariance(y, x, node_mask)
    R = svd_rotation(H)
    return (torch.einsum("gij,gnj->gni", R, y) + x_mu - torch.einsum("gij,gnj->gni", R, y_mu)) * m


def check_kabsch(kb, dev) -> dict:
    """Phase 2: the Kabsch kernel (Horn's quaternion, `csrc/kabsch.cu`)
    against the SVD alignment on the card at the training shape, G = 32
    graphs of N = 48 slots: 8 random rotations of a noisy copy, 8 mirrored
    (the best orthogonal map is a reflection), 8 near-planar, 8 single-atom
    graphs; some graphs padded. Non-degenerate graphs compare the aligned
    positions, degenerate ones the aligned RMSD, 1e-5 of the largest
    coordinate. `kabsch_align` must not make the host wait."""
    from jamun_tpu_torch.ops.geometry import kabsch_align, svd_rotation

    G, N = 32, 48
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(G, N, 3, generator=g, device=dev)
    q, _ = torch.linalg.qr(torch.randn(G, 3, 3, generator=g, device=dev))
    q = q * torch.sign(torch.linalg.det(q))[:, None, None]
    y = torch.einsum("gnj,gij->gni", x, q) + 0.05 * torch.randn(G, N, 3, generator=g, device=dev)
    y[8:16] = y[8:16] * torch.tensor([1.0, 1.0, -1.0], device=dev)
    x[16:24, :, 2] *= 1e-3
    mask = torch.ones(G, N, dtype=torch.bool, device=dev)
    mask[24:, 1:] = False
    mask[:8, 40:] = False
    x, y = x * mask[..., None], y * mask[..., None]
    want = svd_aligned(y, x, mask)
    before = kb.KERNEL.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kabsch_align(y, x, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kb.KERNEL.launches - before == 1
    assert torch.isfinite(got).all()
    scale = x.abs().max().item()
    pos_err = (got[:24] - want[:24]).abs().max().item()

    def rmsd(a):
        return ((a - x) ** 2).sum(-1).sum(-1).div(mask.sum(-1)).sqrt()

    rmsd_err = (rmsd(got)[24:] - rmsd(want)[24:]).abs().max().item()
    abs_e = max(pos_err, rmsd_err)
    log(f"phase 2: Kabsch G={G} N={N}: aligned positions max abs err {pos_err:.3g}, "
        f"degenerate graphs' RMSD {rmsd_err:.3g} (tol {1e-5 * scale:.3g}, 1e-5 of the max); "
        "no host wait")
    assert abs_e <= 1e-5 * scale, (pos_err, rmsd_err, scale)
    H = covariance(y, x, mask)[0]
    R_k, R_p = kb.kabsch_rotation(H), kb.kabsch_rotation_plain(H)
    rot_abs, _ = rel_err(R_k, R_p)  # entries of rotations: at most 1
    assert rot_abs <= 1e-5, f"Kabsch kernel vs its plain version: {rot_abs:.3g} > 1e-5"
    flops = G * kb.SWEEPS * 6 * 2 * (2 * 4 * 4 + 4 * 4)  # each rotation: two sides of A, one of V
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    t_bytes = 2 * H.numel() * 4 / PEAK_BYTES_PER_S * 1e3
    row = dict(
        name="kabsch", route="cuda", source="jamun_tpu_torch/csrc/kabsch.cu", replaces=None,
        max_abs_err=abs_e, rotation_vs_plain_abs_err=rot_abs, G=G, N=N,
        ms=cuda_time_ms(lambda: kb.kabsch_rotation(H), 20),
        plain_ms=cuda_time_ms(lambda: kb.kabsch_rotation_plain(H), 5),
        svd_ms=cuda_time_ms(lambda: svd_rotation(H), 5),
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None,
    )
    log(f"phase 2: Kabsch rotation kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"SVD rotation {row['svd_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}); "
        f"rotations vs the plain version max abs err {rot_abs:.3g} (tol 1e-5)")
    return row


def rel_leaves(got: dict, want: dict) -> dict:
    """max |got - want| / max |want| per key (empty tensors left out)."""
    return {k: rel_err(got[k], want[k])[1] for k in want if want[k].numel()}


def check_conv_block_bwd(k2, k4, models, dev, card_tol, shapes=None) -> list:
    """Phase 5a: K4 against its plain version on K2's residuals, at the
    training shape and N = 112, bf16 and f32, projector and hidden block;
    K1's features and K2's residuals against theirs on the way. `shapes`
    (label -> a host `GraphBatch`) gives other batches to hold them on."""
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig, normalization_factors
    from jamun_tpu_torch.ops.cuda import edge_features as k1
    from jamun_tpu_torch.utils.testing import make_test_batch

    config = DenoiserConfig(max_radius=1.0, average_squared_distance=0.3)
    c_in = normalization_factors(SIGMA, config.average_squared_distance)[0]
    cutoff = Denoiser(models[torch.float32], config).effective_radial_cutoff(SIGMA) / c_in
    shapes = shapes or {
        "train": make_test_batch(num_graphs=32, max_nodes=48, nodes_per_graph=[44] * 32,
                                 max_bonds=96, device="cpu"),
        "N112": make_test_batch(num_graphs=32, max_nodes=112, nodes_per_graph=[112] * 32,
                                max_bonds=224, scale=0.35, device="cpu"),
    }
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for label, batch in shapes.items():
        batch = batch.to_device(dev)
        G, N = batch.pos.shape[:2]
        B = batch.bond_src.shape[1]
        pos = (batch.pos * c_in).contiguous()
        geo = (pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask, cutoff, 32)
        for cdt in (torch.bfloat16, torch.float32):
            tag = f"{label} N={N} G={G} {str(cdt).split('.')[-1]}"
            ef, bf = k1.edge_features(*geo, cdt)
            ef_p, bf_p = k1.edge_features_plain(*geo, cdt)
            torch.cuda.synchronize()
            adj_mismatch = int((ef[..., 3] != ef_p[..., 3]).sum()) + int((bf[..., 3] != bf_p[..., 3]).sum())
            assert adj_mismatch == 0, f"K1 {tag}: {adj_mismatch} adjacency entries differ"
            k1_abs, k1_err = map(max, zip(rel_err(ef, ef_p), rel_err(bf, bf_p)))
            assert k1_err <= card_tol[cdt], f"K1 {tag}: rel err {k1_err:.3g}"
            del ef_p, bf_p
            n_dense = int(ef[..., 3].sum(dtype=torch.float32))
            n_pairs = n_dense + int(bf[..., 3].sum(dtype=torch.float32))
            model = models[cdt]
            for block_name, blk, S, V in (
                ("projector", model.ConvBlock_0, 56, 0),
                ("hidden", model._HiddenLayer_0.ConvBlock_0, 120, 32),
            ):
                conv = blk.Conv_0
                masters = k2.block_master_weights(
                    conv.radial_nn, conv._post_linear, blk.IrrepsLinear_1, blk.IrrepsLinear_0,
                    model.embed_bondedness[0], model.embed_bondedness[1], S=S, V=V,
                )
                w = k2.cast_block_weights(masters, cdt)
                x = torch.randn((G, N, S + 3 * V), generator=gen, device=dev).to(cdt)
                out, agg, deg = k2.fused_conv_block(
                    x, ef, bf, batch.bond_src, batch.bond_dst, w, residuals=True
                )
                agg_p, deg_p = k2.conv_block_residuals_plain(
                    x, ef, bf, batch.bond_src, batch.bond_dst, w
                )
                out_p = k2.fused_conv_block_plain(x, ef, bf, batch.bond_src, batch.bond_dst, w)
                torch.cuda.synchronize()
                assert torch.isfinite(out).all(), f"K2 {block_name} {tag}: non-finite output"
                out_abs, out_err = rel_err(out, out_p)
                assert out_err <= card_tol[cdt], f"K2 output {block_name} {tag}: {out_err:.3g}"
                res_err = max(rel_err(agg, agg_p)[1], rel_err(deg, deg_p)[1])
                assert res_err <= card_tol[cdt], f"K2 residuals {block_name} {tag}: {res_err:.3g}"
                del out_p
                g = torch.randn(out.shape, generator=gen, device=dev)
                args = (g, x, ef, bf, batch.bond_src, batch.bond_dst, w, agg, deg)
                got = k4.conv_block_bwd(*args)
                want = k4.conv_block_bwd_plain(*args)
                torch.cuda.synchronize()
                for k, t in got.items():
                    assert torch.isfinite(t).all(), f"K4 {block_name} {tag}: non-finite {k}"
                errs = rel_leaves(got, want)
                worst = max(errs, key=errs.get)
                assert errs[worst] <= card_tol[cdt], (
                    f"K4 {block_name} {tag}: {worst} rel err {errs[worst]:.3g} > {card_tol[cdt]}"
                )
                abs_e = max(rel_err(got[k], want[k])[0] for k in errs)
                Wd, Sc, Vg, C0 = 2 * S + 3 * V, w.Sc, w.Vg, w.Sc + w.Vg
                pair_flops = 2 * n_pairs * (32 * 64 + 3 * 64 * Wd + 32 * 64)
                node_flops = 2 * G * N * (
                    (S + V) * C0 + 3 * (S + 2 * V) * Vg  # post-linear recomputed
                    + 2 * (Sc * Sc + 3 * Vg * Vg + S * Sc + 3 * V * Vg)  # lin2, skip: dW and dx
                    + 2 * ((S + V) * C0 + 3 * (S + 2 * V) * Vg)  # post-linear: dW and d_in
                )
                flops = pair_flops + node_flops
                k4_bytes = (
                    g.numel() * 4 + (x.numel() + bf.numel()) * x.element_size()
                    + ef_bytes(ef, n_dense) + 2 * B * G * 8 + agg.numel() * 4 + deg.numel() * 4
                    + sum(t.numel() * t.element_size() for t in w.tensors())
                    + sum(t.numel() * 4 for t in got.values())
                )
                t_ops = flops / PEAK_FLOPS[cdt] * 1e3
                t_bytes = k4_bytes / PEAK_BYTES_PER_S * 1e3
                occ = k4.occupancy(N, B, S, V, cdt)
                assert occ["smem_bytes"] == k4.pair_layout(N, B, S, V, cdt)["smem_bytes"]
                row = dict(
                    shape=f"{block_name} {tag}", max_abs_err=abs_e, max_rel_err=errs[worst],
                    worst_leaf=worst, rel_err_by_leaf=errs, residual_rel_err=res_err,
                    k1_rel_err=k1_err, k1_abs_err=k1_abs, k1_adjacency_mismatch=adj_mismatch,
                    k2_out_rel_err=out_err, k2_out_abs_err=out_abs, tol=card_tol[cdt],
                    ms=cuda_time_ms(lambda: k4.conv_block_bwd(*args), 10),
                    prev_ms=PREV_MS.get(("conv_block_bwd", f"{block_name} {tag}")),
                    plain_ms=cuda_time_ms(lambda: k4.conv_block_bwd_plain(*args), 2),
                    bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    visited_pairs=n_pairs, flops=flops, dtype=str(cdt), N=N, G=G,
                    block=block_name, label=label, pair_pass=occ,
                )
                rows.append(row)
                prev = f" (before the redesign: {row['prev_ms']:.4f})" if row["prev_ms"] else ""
                log(f"phase 5: K4 {block_name} {tag}: worst rel err {errs[worst]:.3g} ({worst}), "
                    f"max abs {abs_e:.3g} (tol {card_tol[cdt]}); K1 rel {k1_err:.3g}, adjacency "
                    f"equal; K2 output rel {out_err:.3g} (max abs {out_abs:.3g}), "
                    f"residuals rel {res_err:.3g}; "
                    f"kernel {row['ms']:.4f} ms{prev}, plain {row['plain_ms']:.4f} ms, "
                    f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), {n_pairs} visited pairs; "
                    f"pair pass {occ['registers']} registers, {occ['spill_bytes']} spill bytes, "
                    f"{occ['smem_bytes']} B shared, {occ['ctas_per_sm']} CTAs per SM")
                del got, want, out, agg, deg, agg_p, deg_p
            del ef, bf
            torch.cuda.empty_cache()
    return rows


def stack_flops_bytes(args, n_pairs: int, out: torch.Tensor):
    """The operations and bytes one whole forward needs on these inputs:
    the ConvBlock count of phase 2 over the projector and the hidden blocks
    at the run's visited pairs plus the head's products; positions,
    embedding, bonds, masks, every weight once and the output."""
    pos, node_mask, bond_src, bond_dst, bond_mask, _, nf0, proj_w, layers_w, scales, skipw, head = args[:12]
    G, N = pos.shape[:2]
    L = scales.shape[0]
    S, V = proj_w.Sc, proj_w.Vg

    def block(s_in, v_in):
        return 2 * n_pairs * (32 * 64 + 64 * (2 * s_in + 3 * v_in)) + 2 * G * N * (
            (s_in + v_in) * (S + V) + 3 * (s_in + 2 * v_in) * V + S * S + 3 * V * V
            + s_in * S + 3 * v_in * V
        )

    C0o, V1o = head.f0.shape[1], head.f1.shape[1]
    head_flops = 2 * G * N * (S * S + S * V + 3 * V * V + S * C0o + 3 * V * V1o)
    flops = block(proj_w.S, 0) + L * block(S, V) + head_flops
    tensors = [pos, node_mask, bond_src, bond_dst, bond_mask, nf0, scales, skipw, out,
               *proj_w.tensors(), *layers_w.tensors(), *head[:5]]
    return flops, sum(t.numel() * t.element_size() for t in tensors)


def check_e3_stack(k1, k3, models, stack_models, dev, c_in: float, c_noise: float, cutoff: float) -> list:
    """Phase 2, K3: the whole-model kernel against its plain version at the
    4AA and 2AA walk shapes and on one batch of mixed sizes, bf16 and f32,
    and the stack model against the layerwise kernel path (K1, six K2, the
    layerwise head) on the same weights."""
    from jamun_tpu_torch.utils.testing import make_test_batch

    shapes = {"4AA": (44, [44] * 256), "2AA": (19, [19] * 256), "mixed": (44, [44, 41])}
    launch_shapes = {}
    for N in (44, 19):  # the kernel's own split of a graph over its cluster, and 8 atoms per CTA
        for cdt in (torch.bfloat16, torch.float32):
            shapes_n = {a: k3.launch_shape(N, 2 * N, 120, 32, 56, a, compute_dtype=cdt) for a in (0, 8)}
            for a, sh in shapes_n.items():
                mirror = k3.stack_shape(N, 2 * N, 120, 32, 56, a, compute_dtype=cdt)
                assert {k: sh[k] for k in mirror} == mirror, (sh, mirror)
            launch_shapes[N, cdt] = shapes_n
            log(f"phase 2: K3 {str(cdt).split('.')[-1]} launch shape at N={N}: {shapes_n[0]}; "
                f"with 8 atoms per CTA: {shapes_n[8]}")
    layerwise_tol = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    c_noise_t = torch.full((1,), c_noise, dtype=torch.float32, device=dev)
    rows = []
    for label, (N, nodes) in shapes.items():
        G = len(nodes)
        batch = make_test_batch(num_graphs=G, max_nodes=N, nodes_per_graph=nodes, max_bonds=2 * N,
                                scale=0.35, device=dev)
        scaled = batch.replace_pos((batch.pos * c_in).contiguous())
        for cdt in (torch.bfloat16, torch.float32):
            tag = f"{label} N={N} G={G} {str(cdt).split('.')[-1]}"
            model = stack_models[cdt]
            nf0 = model.NoiseConditionalScaling_0(
                model.AtomEmbeddingWithResidueInformation_0(scaled), c_noise_t
            )
            args = model._stack_args(scaled, nf0, c_noise_t, cutoff)
            got = k3.e3conv_stack(*args)
            want = k3.e3conv_stack_plain(*args)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), f"K3 {tag}: non-finite output"
            abs_e, rel_e = rel_err(got, want)
            assert rel_e <= TOL[cdt], f"K3 {tag}: rel err {rel_e:.3g} > {TOL[cdt]}"
            assert model._stack_ok(scaled, c_noise_t)
            whole = model(scaled, c_noise_t, cutoff)
            layerwise = models[cdt](scaled, c_noise_t, cutoff)
            lw_abs, lw_rel = rel_err(whole, layerwise)
            assert lw_rel <= layerwise_tol[cdt], (
                f"K3 {tag}: stack vs layerwise kernel path rel err {lw_rel:.3g} > {layerwise_tol[cdt]}"
            )
            ef, bf = k1.edge_features(*args[:6], 32, cdt)
            n_pairs = int(ef[..., 3].sum(dtype=torch.float32)) + int(bf[..., 3].sum(dtype=torch.float32))
            del ef, bf
            flops, nbytes = stack_flops_bytes(args, n_pairs, got)
            t_ops = flops / PEAK_FLOPS[cdt] * 1e3
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            timed = label != "mixed"
            row = dict(
                shape=tag, max_abs_err=abs_e, max_rel_err=rel_e, tol=TOL[cdt],
                layerwise_rel_err=lw_rel, layerwise_abs_err=lw_abs, layerwise_tol=layerwise_tol[cdt],
                ms=cuda_time_ms(lambda: k3.e3conv_stack(*args), 10) if timed else None,
                ms_8_atoms_per_cta=(
                    cuda_time_ms(lambda: k3.e3conv_stack(*args, atoms_per_cta=8), 10) if timed else None
                ),
                launch_shape=launch_shapes[N, cdt], prev_ms=PREV_MS.get(("e3_stack", tag)),
                registers=launch_shapes[N, cdt][0]["registers"],
                ctas_per_sm=launch_shapes[N, cdt][0]["ctas_per_sm"],
                plain_ms=cuda_time_ms(lambda: k3.e3conv_stack_plain(*args), 2) if timed else None,
                bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                visited_pairs=n_pairs, flops=flops, bytes=nbytes, dtype=str(cdt), N=N, G=G, label=label,
            )
            rows.append(row)
            times = (f"kernel {row['ms']:.4f} ms (before the redesign: {row['prev_ms']:.4f}; "
                     f"{row['ms_8_atoms_per_cta']:.4f} ms with 8 atoms per CTA), "
                     f"plain {row['plain_ms']:.4f} ms, " if timed else "")
            log(f"phase 2: K3 {tag}: max abs err {abs_e:.3g}, rel {rel_e:.3g} (tol {TOL[cdt]}); "
                f"vs layerwise kernel path rel {lw_rel:.3g} (tol {layerwise_tol[cdt]}); {times}"
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), {n_pairs} visited pairs; "
                f"{row['registers']} registers, {row['ctas_per_sm']} CTAs per SM")
            del got, want, whole, layerwise
            torch.cuda.empty_cache()
    return rows


def density_scale(n_atoms: int) -> float:
    """The blob width of `make_test_batch` that keeps the atom density of the
    4AA shape (N = 44 at scale 0.35) at n_atoms."""
    return 0.35 * (n_atoms / 44.0) ** (1.0 / 3.0)


def tiled_batch(n_atoms: int, num_graphs: int, dev, nodes_per_graph=None):
    from jamun_tpu_torch.utils.testing import make_test_batch

    return make_test_batch(
        num_graphs=num_graphs, max_nodes=n_atoms,
        nodes_per_graph=nodes_per_graph or [n_atoms] * num_graphs, max_bonds=2 * n_atoms,
        scale=density_scale(n_atoms), device=dev,
    )


def check_fused_block_tiled(k1, k2, k5, models, batches, dev, c_in: float, cutoff: float,
                            shapes=None) -> list:
    """Phase 2, K5: the tiled ConvBlock against its plain version at both
    walk shapes (N = 256, G = 64 and N = 512, G = 16), on a ragged batch
    (N = 203, no multiple of 8) and at N = 1200 (where the bf16 build walks
    the sources in passes), bf16 and f32, projector and hidden block,
    the degree it counted equal to the plain version's on every atom; then
    against K2 on K1's features at N = 112, bit for bit in both dtypes (the
    same pairs in the same order through the same steps). `shapes` (label
    -> batch) gives other batches to hold it against its plain version on."""
    shapes = shapes or {
        "N256": tiled_batch(256, 64, dev),
        "N512": tiled_batch(512, 16, dev),
        "ragged": tiled_batch(203, 6, dev, [203, 197, 160, 131, 64, 9]),
        "passes": tiled_batch(1200, 2, dev, [1200, 1111]),
        "N112": batches["5AA"],
    }
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for label, batch in shapes.items():
        G, N = batch.pos.shape[:2]
        B = batch.bond_src.shape[1]
        geo = k5.tiled_geometry_inputs(
            batch.pos * c_in, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask,
            cutoff, 32,
        )
        real = batch.node_mask.sum(-1).float()
        for cdt in (torch.bfloat16, torch.float32):
            model = models[cdt]
            for block_name, blk, S, V in (
                ("projector", model.ConvBlock_0, 56, 0),
                ("hidden", model._HiddenLayer_0.ConvBlock_0, 120, 32),
            ):
                tag = f"{block_name} {label} N={N} G={G} {str(cdt).split('.')[-1]}"
                x = torch.randn((G, N, S + 3 * V), generator=gen, device=dev).to(cdt)
                conv = blk.Conv_0
                w = k2.pack_block_weights(
                    conv.radial_nn, conv._post_linear, blk.IrrepsLinear_1, blk.IrrepsLinear_0,
                    model.embed_bondedness[0], model.embed_bondedness[1], S=S, V=V, cdt=cdt,
                )
                occ = k5.occupancy(N, B, S, V, w.Sc, w.Vg, cdt)
                smem = occ["smem_bytes"]
                assert smem == k5.layout(N, B, S, V, w.Sc, w.Vg, cdt)["smem_bytes"], (tag, occ)
                got, deg = k5.fused_block_tiled(x, geo, w, return_degree=True)
                torch.cuda.synchronize()
                assert torch.isfinite(got).all(), f"K5 {tag}: non-finite output"
                if label == "N112":  # the same block through K1 and K2
                    ef, bf = k1.edge_features(*geo[:7], cdt)
                    want, _, deg_p = k2.fused_conv_block(
                        x, ef, bf, batch.bond_src, batch.bond_dst, w, residuals=True
                    )
                    del ef, bf
                    against = "K2 on K1's features"
                else:
                    want, deg_p = k5.fused_block_tiled_plain(x, geo, w, return_degree=True)
                    against = "plain"
                deg_mismatch = int((deg != deg_p).sum())
                assert deg_mismatch == 0, f"K5 {tag}: the degree differs on {deg_mismatch} atoms"
                abs_e, rel_e = rel_err(got, want)
                assert rel_e <= TOL[cdt], f"K5 {tag} vs {against}: rel err {rel_e:.3g} > {TOL[cdt]}"
                if label == "N112":
                    assert torch.equal(got, want), f"K5 {tag}: differs from K2 by {abs_e:.3g}"
                    against += ", bit for bit"
                n_pairs = int(deg.sum(dtype=torch.float64))
                n_bonds = int(batch.bond_mask.sum())
                share = (n_pairs - n_bonds) / float((real * (real - 1)).sum())
                Wd, Sc, Vg = 2 * S + 3 * V, w.Sc, w.Vg
                flops = 2 * n_pairs * (32 * 64 + 64 * Wd) + 2 * G * N * (
                    (S + V) * (Sc + Vg) + 3 * (S + 2 * V) * Vg + Sc * Sc + 3 * Vg * Vg
                    + S * Sc + 3 * V * Vg
                )
                nbytes = sum(t.numel() * t.element_size() for t in (
                    x, geo.pos, geo.node_mask, geo.bond_src, geo.bond_dst, geo.bond_mask, got,
                    *w.tensors(),
                ))
                t_ops = flops / PEAK_FLOPS[cdt] * 1e3
                t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
                timed = label not in ("ragged", "passes")
                row = dict(
                    shape=tag, against=against, max_abs_err=abs_e, max_rel_err=rel_e, tol=TOL[cdt],
                    ms=cuda_time_ms(lambda: k5.fused_block_tiled(x, geo, w), 5) if timed else None,
                    prev_ms=PREV_MS.get(("fused_block_tiled", tag)),
                    plain_ms=(cuda_time_ms(lambda: k5.fused_block_tiled_plain(x, geo, w), 1)
                              if timed and against == "plain" else None),
                    bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                    visited_pairs=n_pairs, share_inside_cutoff=share, flops=flops, bytes=nbytes,
                    smem_bytes=smem, dtype=str(cdt), N=N, G=G, block=block_name, label=label,
                    registers=occ["registers"], spill_bytes=occ["spill_bytes"],
                    ctas_per_sm=occ["ctas_per_sm"], atoms_per_cta=occ["atoms_per_cta"],
                    sources_per_pass=occ["sources_per_pass"],
                )
                rows.append(row)
                times = f"kernel {row['ms']:.4f} ms, " if timed else ""
                if row["prev_ms"] is not None:
                    times += f"before the redesign {row['prev_ms']:.4f} ms, "
                if row["plain_ms"] is not None:
                    times += f"plain {row['plain_ms']:.4f} ms, "
                log(f"phase 2: K5 {tag} vs {against}: max abs err {abs_e:.3g}, rel {rel_e:.3g} "
                    f"(tol {TOL[cdt]}), degree equal on all atoms; {times}"
                    f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), {n_pairs} visited pairs "
                    f"({100 * share:.1f}% of the ordered pairs inside the cutoff); "
                    f"{smem} B shared, {occ['atoms_per_cta']} atoms per CTA, "
                    f"{occ['sources_per_pass']} sources per pass, {occ['registers']} registers, "
                    f"{occ['spill_bytes']} spill bytes, {occ['ctas_per_sm']} CTAs per SM")
                del got, want, deg, deg_p
                torch.cuda.empty_cache()
    return rows


def share_inside_cutoff(y: torch.Tensor, node_mask: torch.Tensor, den, sigma: float) -> float:
    """The share of the ordered pairs of real atoms that the denoiser finds
    inside its cutoff at positions y [G, N, 3] (mean-centred and scaled as
    `Denoiser.xhat` does; self-pairs left out)."""
    from jamun_tpu_torch.models.denoiser import normalization_factors
    from jamun_tpu_torch.ops.geometry import mean_center

    c_in = normalization_factors(sigma, den.config.average_squared_distance)[0]
    scaled = mean_center(y, node_mask) * c_in
    pair = node_mask[:, :, None] & node_mask[:, None, :]
    pair &= ~torch.eye(y.shape[1], dtype=torch.bool, device=y.device)
    inside = (torch.cdist(scaled, scaled) < den.effective_radial_cutoff(sigma) / c_in) & pair
    return inside.sum().item() / pair.sum().item()


def tiled_walks(denoisers: dict, dev, card: str, kernels: dict):
    """Phase 3c: the dense path above 128 atoms through `Sampler.sample`,
    BAOAB: N = 256, G = 64, 101 steps (the default model, whose "auto"
    neighbour mode stays dense below 512 atoms) and N = 512, G = 16, 21
    steps (`neighbor_mode="dense"`). K5's work follows the pairs inside the
    cutoff, and a walk under random weights is not held together by a
    trained score, so the share of pairs inside the cutoff is printed at the
    first and the last saved frame, each with the time of one
    `Denoiser.score` call on that fixed frame (a steady load, after the
    walk's launches were read). Returns the walks' numbers, the denoiser
    calls the walks made, K5's launches in them, and the N = 256 batch at
    its start and with the positions of its walk's last frame."""
    from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
    from jamun_tpu_torch.sampling.sampler import Sampler
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler

    walks, calls, launched, batch256, batch256_end = {}, 0, 0, None, None
    for label, n_atoms, num_graphs, steps in (("N256", 256, 64, 101), ("N512", 512, 16, 21)):
        batch = tiled_batch(n_atoms, num_graphs, dev)
        G, N = batch.pos.shape[:2]
        batch256 = batch256 or batch
        cfg = MCMCConfig(delta=0.04, friction=1.0, M=1.0, steps=steps, save_every_n_steps=1,
                         score_fn_clip=100.0)
        times = BatchTimes()
        before = {name: k.launches for name, k in kernels.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = Sampler(callbacks=[times], device=dev).sample(
            denoisers[label], SingleMeasurementSampler(BAOAB(cfg), SIGMA), 1, batch, seed=2,
        )
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        used = {name: k.launches - before[name] for name, k in kernels.items()}
        calls += steps + 1  # initial score, steps - 1 updates, the final jump
        launched += used["fused_block_tiled"]
        assert used == {**dict.fromkeys(kernels, 0), "fused_block_tiled": 6 * (steps + 1)}, (
            label, used)
        check_samples(out[0], G, N, steps, label)
        # what K1 would have written at every forward on the other dense path
        ef_bytes_bf16 = G * N * N * 36 * 2
        assert peak < ef_bytes_bf16, (label, peak, ef_bytes_bf16)
        walk_s = sum(times.seconds)
        frames = [
            batch.replace_pos(
                torch.from_numpy(np.stack([entry["y_traj"][:, frame] for entry in out[0]])).to(dev)
            )
            for frame in (0, steps - 1)
        ]
        shares = [share_inside_cutoff(f.pos, batch.node_mask, denoisers[label], SIGMA) for f in frames]
        with torch.no_grad():
            score_ms = [cuda_time_ms(lambda f=f: denoisers[label].score(f, SIGMA), 5) for f in frames]
        if label == "N256":
            batch256_end = frames[1]
        walks[label] = dict(
            N=N, G=G, steps=steps, frames=steps, seconds=dt, walk_seconds=walk_s,
            ms_per_step=walk_s * 1e3 / steps, ms_per_sample=walk_s * 1e3 / (G * steps),
            peak_bytes_above_start=peak, edge_feature_bytes_bf16=ef_bytes_bf16,
            share_inside_cutoff_first_frame=shares[0], share_inside_cutoff_last_frame=shares[1],
            score_ms_first_frame=score_ms[0], score_ms_last_frame=score_ms[1],
        )
        log(f"phase 3: tiled walk-jump {label} N={N} G={G} steps={steps} through Sampler.sample: "
            f"walk {walk_s:.3f} s, with unbatching {dt:.3f} s, "
            f"{walks[label]['ms_per_sample']:.6f} ms/sample, {walks[label]['ms_per_step']:.3f} "
            f"ms/step on {card}; {100 * shares[0]:.2f}% of the ordered pairs inside the cutoff at "
            f"the first frame (one score call there {score_ms[0]:.3f} ms), {100 * shares[1]:.2f}% at "
            f"the last ({score_ms[1]:.3f} ms); "
            f"K5 {used['fused_block_tiled']} launches, K1/K2/K3 none; peak "
            f"device memory {peak / 2**20:.1f} MiB above the start (one [G, N, N, 36] bf16 "
            f"tensor: {ef_bytes_bf16 / 2**20:.1f} MiB)")
    return walks, calls, launched, batch256, batch256_end


def check_tiled_score(dense_models: dict, config, dev) -> dict:
    """Phase 4 above 128 atoms: the f32 score of the K5 path at N = 256 on the
    card against the plain path on the CPU, and E(3) equivariance of the K5
    path in f32 and bf16."""
    from jamun_tpu_torch.models.denoiser import Denoiser
    from jamun_tpu_torch.models.e3conv import E3Conv
    from jamun_tpu_torch.ops.cuda import fused_block_tiled as k5

    small = tiled_batch(256, 2, dev, [256, 251])
    ref_model = E3Conv(
        tensor_product="uvu", dtype=None, device="cpu", plain=True, neighbor_mode="dense")
    ref_model.load_state_dict(dense_models[torch.float32].state_dict())
    ref_model.requires_grad_(False)
    before = k5.KERNEL.launches
    with torch.no_grad():
        s_cpu = Denoiser(ref_model, config).score(small.to("cpu"), SIGMA)
        s_card = Denoiser(dense_models[torch.float32], config).score(small, SIGMA)
    abs_e, rel_e = rel_err(s_card.cpu(), s_cpu)
    log(f"phase 4: f32 score at N=256, K5 path on the card vs plain path on the CPU: "
        f"max abs err {abs_e:.3g}, rel {rel_e:.3g} (tol 1e-3)")
    assert rel_e < 1e-3
    q, r = torch.linalg.qr(torch.randn(3, 3, generator=torch.Generator().manual_seed(5)))
    R = (q * torch.sign(torch.diagonal(r))).to(dev)
    if torch.det(R) < 0:
        R = -R
    shift = torch.tensor([0.3, -0.2, 0.5], device=dev)
    mask = small.node_mask[..., None].float()
    out = dict(score_rel_err=rel_e)
    for cdt, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
        d = Denoiser(dense_models[cdt], config)
        with torch.no_grad():
            s = d.score(small, SIGMA)
            s_rot = d.score(small.replace_pos((small.pos @ R.T + shift) * mask), SIGMA)
        err = ((s_rot - (s @ R.T - shift / SIGMA**2) * mask).abs().max() / s.abs().max()).item()
        log(f"phase 4: E(3) check at N=256, K5 path, {str(cdt).split('.')[-1]}: "
            f"|score(Ry+t) - (R score(y) - t/sigma^2)| / max|score| = {err:.3g} (tol {tol})")
        assert err < tol
        out[f"e3_err_{str(cdt).split('.')[-1]}"] = err
    assert k5.KERNEL.launches - before == 5 * 6  # five score calls, six blocks each
    return out


NBR_SKIN = 1.0  # nm of the walk's coordinates: `bench.py`'s Verlet skin on the sparse path


def chain_batch(n_atoms: int, num_graphs: int, dev, nodes_per_graph=None):
    """`bench.py`'s sparse shape (`bench.py:259-281`): chain-bonded graphs of
    `make_test_batch` at worm-like-chain positions (`make_chain_positions`,
    seed 0); the positions of padding atoms are zero."""
    from jamun_tpu_torch.utils.testing import make_chain_positions, make_test_batch

    batch = make_test_batch(
        num_graphs=num_graphs, max_nodes=n_atoms,
        nodes_per_graph=nodes_per_graph or [n_atoms] * num_graphs, max_bonds=2 * n_atoms,
        scale=0.35, device=dev,
    )
    pos = torch.from_numpy(make_chain_positions(num_graphs, n_atoms, seed=0)).to(dev)
    return batch.replace_pos(pos * batch.node_mask[..., None])


def check_nbr_kernels(k6, k7, models, dev, c_in: float, cutoff: float, shapes=None) -> dict:
    """Phase 2, K6 and K7 against their plain versions, bf16 and f32, on
    `bench.py`'s chain geometry: N = 512, G = 8 with the list of one forward
    and with the skin-1.0 Verlet list, N = 1024, G = 2, and a ragged batch
    (N = 203, with the list of one forward and with the skin-1.0 list). K7
    on each list; K6 for the projector and a hidden block on the model's
    edge attributes (A = 64), and on the cached lists also on K7's radial
    half (A = 32, the bondedness block folded into b1). The
    degree, the mask and the kept slots' indices must be exactly equal. The
    bounds count the kept slots only (the data's work, not K's). `shapes`
    (label -> (batch, cached)) gives other batches to hold them on."""
    from jamun_tpu_torch.ops.neighbors import capped_neighbor_lists

    shapes = shapes or {
        "N512": (chain_batch(512, 8, dev), False),
        "N512 cached": (chain_batch(512, 8, dev), True),
        "N1024": (chain_batch(1024, 2, dev), False),
        "ragged": (chain_batch(203, 3, dev, [203, 190, 150]), False),
        "ragged cached": (chain_batch(203, 3, dev, [203, 190, 150]), True),
    }
    gen = torch.Generator(device=dev).manual_seed(8)
    rows = {"nbr_conv": [], "nbr_edge_features": []}
    for label, (batch, cached) in shapes.items():
        G, N = batch.pos.shape[:2]
        scaled = batch.replace_pos((batch.pos * c_in).contiguous())
        list_cutoff = cutoff + NBR_SKIN * c_in if cached else cutoff
        idx, superset, overflow = capped_neighbor_lists(scaled.pos, batch.node_mask, list_cutoff, 32)
        K, slots = idx.shape[-1], idx.numel()
        in_list = int(superset.sum())
        for cdt in (torch.bfloat16, torch.float32):
            dt = str(cdt).split(".")[-1]
            tag = f"{label} N={N} G={G} {dt}"
            model = models[cdt]
            args7 = (scaled.pos, idx, superset, cutoff, 32, cdt)
            got7 = k7.nbr_edge_features(*args7)
            want7 = k7.nbr_edge_features_plain(*args7)
            torch.cuda.synchronize()
            mismatch = int((got7[2] != want7[2]).sum()) + int((got7[3] != want7[3]).sum())
            assert mismatch == 0, f"K7 {tag}: {mismatch} mask or index entries differ"
            abs_e, rel_e = map(max, zip(rel_err(got7[0], want7[0]), rel_err(got7[1], want7[1])))
            assert rel_e <= TOL[cdt], f"K7 {tag}: rel err {rel_e:.3g} > {TOL[cdt]}"
            kept = int(got7[2].sum(dtype=torch.float64))
            esz = got7[0].element_size()
            k7_bytes = scaled.pos.numel() * 4 + slots * (8 + 1) + slots * ((4 + 32) * esz + 4 + 8)
            k7_flops = slots * (32 * 7 + 30)  # per slot: 32 Gaussians, the distance, the harmonics
            t_ops, t_bytes = k7_flops / PEAK_FLOPS[torch.float32] * 1e3, k7_bytes / PEAK_BYTES_PER_S * 1e3
            occ = k7.occupancy(G, N, K, 32, cdt)
            row = dict(
                shape=tag, max_abs_err=abs_e, max_rel_err=rel_e, tol=TOL[cdt],
                ms=cuda_time_ms(lambda: k7.nbr_edge_features(*args7), 20),
                device_ms=device_time_ms(lambda: k7.nbr_edge_features(*args7)),
                prev_ms=PREV_MS.get(("nbr_edge_features", tag)),
                prev_device_ms=PREV_DEVICE_MS.get(("nbr_edge_features", tag)),
                plain_ms=cuda_time_ms(lambda: k7.nbr_edge_features_plain(*args7), 3),
                bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                slots=slots, in_list=in_list, kept=kept, bytes=k7_bytes, dtype=str(cdt), N=N, G=G,
                label=label, registers=occ["registers"], ctas_per_sm=occ["ctas_per_sm"],
                smem_bytes=occ["smem_bytes"], ctas=occ["ctas"],
            )
            rows["nbr_edge_features"].append(row)
            prev, prev_dev = prev_times(row)
            log(f"phase 2: K7 {tag}: max abs err {abs_e:.3g}, rel {rel_e:.3g} (tol {TOL[cdt]}), "
                f"mask and indices equal; kernel {row['ms']:.4f} ms through the wrapper{prev}, "
                f"{row['device_ms']:.4f} on the device alone{prev_dev}; plain {row['plain_ms']:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); {slots} slots, {in_list} in the "
                f"list, {kept} kept ({100 * kept / slots:.1f}%), overflow {overflow.tolist()}; "
                f"{occ['ctas']} CTAs, {occ['registers']} registers, {occ['ctas_per_sm']} CTAs per SM, "
                f"{occ['smem_bytes']} B shared")

            edges, _ = model._sparse_edges(scaled, cutoff, (idx, superset) if cached else None, True)
            variants = [("A64", edges)]
            if cached:  # K7's features, as the `nbr_geom_kernel` walk feeds K6
                variants.append(("A32", dataclasses.replace(
                    edges, sh_nbr=got7[0], attr_nbr=got7[1], nbr_mask=got7[2], nbr_idx=got7[3],
                )))
            for variant, ed in variants:
                for block_name, blk, S, V in (
                    ("projector", model.ConvBlock_0, 56, 0),
                    ("hidden", model._HiddenLayer_0.ConvBlock_0, 120, 32),
                ):
                    x = torch.randn((G, N, S + 3 * V), generator=gen, device=dev).to(cdt)
                    args6 = blk.Conv_0.nbr_kernel_args(x, ed)
                    got, deg = k6.nbr_uvu_conv(*args6)
                    want, deg_p = k6.nbr_uvu_conv_plain(*args6)
                    torch.cuda.synchronize()
                    name = f"K6 {block_name} {variant} {tag}"
                    assert torch.isfinite(got).all(), f"{name}: non-finite output"
                    deg_mismatch = int((deg != deg_p).sum())
                    assert deg_mismatch == 0, f"{name}: the degree differs on {deg_mismatch} atoms"
                    abs_e, rel_e = rel_err(got, want)
                    assert rel_e <= TOL[cdt], f"{name}: rel err {rel_e:.3g} > {TOL[cdt]}"
                    A, Wd = args6[2].shape[-1], 2 * S + 3 * V
                    n_kept = int(deg.sum(dtype=torch.float64))
                    flops = 2 * n_kept * (A * 64 + 64 * Wd)
                    nbytes = (
                        x.numel() * x.element_size() + args6[4].numel() * 4
                        + n_kept * ((4 + A) * args6[1].element_size() + 8)
                        + sum(t.numel() * t.element_size() for t in args6[5:9])
                        + got.numel() * 4 + deg.numel() * 4
                    )
                    t_ops = flops / PEAK_FLOPS[cdt] * 1e3
                    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
                    occ = k6.occupancy(A, K, S, V, cdt)
                    assert occ["smem_bytes"] == k6.layout(A, K, S, V, cdt)["smem_bytes"]
                    row = dict(
                        shape=f"{block_name} {variant} {tag}", max_abs_err=abs_e, max_rel_err=rel_e,
                        tol=TOL[cdt], ms=cuda_time_ms(lambda: k6.nbr_uvu_conv(*args6), 10),
                        prev_ms=PREV_MS.get(("nbr_conv", f"{block_name} {variant} {tag}")),
                        plain_ms=cuda_time_ms(lambda: k6.nbr_uvu_conv_plain(*args6), 2),
                        bound_ms=max(t_ops, t_bytes),
                        bound_by="operations" if t_ops >= t_bytes else "bytes",
                        kept_slots=n_kept, slots=slots, flops=flops, bytes=nbytes, dtype=str(cdt),
                        N=N, G=G, block=block_name, variant=variant, label=label,
                        registers=occ["registers"], spill_bytes=occ["spill_bytes"],
                        ctas_per_sm=occ["ctas_per_sm"], smem_bytes=occ["smem_bytes"],
                    )
                    rows["nbr_conv"].append(row)
                    prev = f" (before the redesign: {row['prev_ms']:.4f})" if row["prev_ms"] else ""
                    log(f"phase 2: {name}: max abs err {abs_e:.3g}, rel {rel_e:.3g} "
                        f"(tol {TOL[cdt]}), degree equal on all atoms; kernel {row['ms']:.4f} ms{prev}, "
                        f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                        f"({row['bound_by']}), {n_kept} kept slots of {slots}; {occ['registers']} "
                        f"registers, {occ['ctas_per_sm']} CTAs per SM, {occ['smem_bytes']} B shared")
                    del got, want, deg, deg_p
            del got7, want7, edges, variants
            torch.cuda.empty_cache()
    return rows


def sparse_walks(den, den_geom, dev, card: str, kernels: dict):
    """Phase 3d: the sparse path through `Sampler.sample` at full flagship
    width with the default `neighbor_mode="auto"`: N = 512, G = 8, 101 BAOAB
    steps on the skin-1.0 Verlet list with `nbr_geom_kernel` off and on, and
    N = 1024, G = 2, 101 steps with the list built at every forward. Every
    launch count is set to 0 just before each walk and read just after: K6
    six times per denoiser call; K7 once per cached score call of the
    `nbr_geom_kernel` walk (the final jump builds its own list) and never
    otherwise; K1, K2, K3, K5 never. Returns the walks' numbers, the
    launches of K6 and K7 in them, and the cached N = 512 batch at the
    positions of its walk's last frame."""
    from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
    from jamun_tpu_torch.sampling.sampler import Sampler
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler

    walks, launched, end_frame = {}, {"nbr_conv": 0, "nbr_edge_features": 0}, None
    steps = 101
    cfg = MCMCConfig(delta=0.04, friction=1.0, M=1.0, steps=steps, save_every_n_steps=1,
                     score_fn_clip=100.0)
    for label, d, n_atoms, num_graphs, skin in (
        ("N512_cached", den, 512, 8, NBR_SKIN),
        ("N512_cached_geom", den_geom, 512, 8, NBR_SKIN),
        ("N1024", den, 1024, 2, 0.0),
    ):
        batch = chain_batch(n_atoms, num_graphs, dev)
        G, N = batch.pos.shape[:2]
        made = []  # the walk's NeighborCachedScore, for its rebuild count
        make = d.make_neighbor_cached_score
        d.make_neighbor_cached_score = lambda *a, make=make, **k: made.append(make(*a, **k)) or made[-1]
        times = BatchTimes()
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = Sampler(callbacks=[times], device=dev).sample(
            d, SingleMeasurementSampler(BAOAB(cfg), SIGMA, neighbor_skin=skin), 1, batch, seed=2,
        )
        dt = time.perf_counter() - t0
        used = {name: k.launches for name, k in kernels.items()}
        del d.make_neighbor_cached_score
        want = dict.fromkeys(kernels, 0)
        want["nbr_conv"] = 6 * (steps + 1)  # initial score, steps - 1 updates, the final jump
        want["nbr_edge_features"] = steps if d is den_geom else 0
        assert used == want, (label, used, want)
        for name in launched:
            launched[name] += used[name]
        check_samples(out[0], G, N, steps, label)
        overflow = times.overflow[0]
        assert overflow is not None, label  # the sparse path reports its cap's dropped edges
        rebuilds = int(made[0].rebuilds) if made else None
        walk_s = sum(times.seconds)
        # the load drifts along a walk under random weights: the kept slots
        # and one score call (its own list) on the first and the last frame
        frames = [
            batch.replace_pos(
                torch.from_numpy(np.stack([entry["y_traj"][:, frame] for entry in out[0]])).to(dev)
            )
            for frame in (0, steps - 1)
        ]
        kept = [kept_slots(f, d, SIGMA) for f in frames]
        end_frame = end_frame or frames[1]
        with torch.no_grad():
            score_ms = [cuda_time_ms(lambda f=f: d.score(f, SIGMA), 5) for f in frames]
        walks[label] = dict(
            N=N, G=G, steps=steps, skin=skin, nbr_geom_kernel=d is den_geom, seconds=dt,
            walk_seconds=walk_s, ms_per_step=walk_s * 1e3 / steps,
            ms_per_sample=walk_s * 1e3 / (G * steps), rebuilds=rebuilds, overflow=overflow,
            launches=used, kept_slots_first_frame=kept[0], kept_slots_last_frame=kept[1],
            score_ms_first_frame=score_ms[0], score_ms_last_frame=score_ms[1],
        )
        if made:
            with torch.no_grad():
                walks[label]["rebuild_ms"] = cuda_time_ms(lambda: made[0].rebuild(batch.pos), 20)
        log(f"phase 3: sparse walk-jump {label} N={N} G={G} steps={steps} skin={skin} "
            f"nbr_geom_kernel={d is den_geom} through Sampler.sample: walk {walk_s:.3f} s, with "
            f"unbatching {dt:.3f} s, {walks[label]['ms_per_sample']:.6f} ms/sample, "
            f"{walks[label]['ms_per_step']:.3f} ms/step on {card}; rebuilds {rebuilds}"
            + (f" (one list build {walks[label]['rebuild_ms']:.4f} ms)" if made else "")
            + f"; overflow reported {overflow}; kept slots {kept[0]} at the first frame (one "
            f"score call there {score_ms[0]:.3f} ms), {kept[1]} at the last ({score_ms[1]:.3f} "
            f"ms); launches K6 {used['nbr_conv']}, K7 {used['nbr_edge_features']}, others none")
    return walks, launched, end_frame


def kept_slots(batch, den, sigma: float) -> int:
    """The slots the sparse path keeps at these positions: the capped list
    of one forward on the geometry `Denoiser.xhat` gives the arch."""
    from jamun_tpu_torch.models.denoiser import normalization_factors
    from jamun_tpu_torch.ops.geometry import mean_center
    from jamun_tpu_torch.ops.neighbors import capped_neighbor_lists

    c_in = normalization_factors(sigma, den.config.average_squared_distance)[0]
    pos = mean_center(batch.pos, batch.node_mask) * c_in
    cutoff = den.effective_radial_cutoff(sigma) / c_in
    return int(capped_neighbor_lists(pos, batch.node_mask, cutoff, den.arch.neighbor_cap)[1].sum())


def check_sparse_score(models: dict, config, dev) -> dict:
    """Phase 4 on the sparse path: the f32 score at N = 512, G = 2 (chain
    positions, "auto") on the card against the plain sparse path on the CPU,
    and E(3) equivariance in f32 and bf16."""
    from jamun_tpu_torch.models.denoiser import Denoiser
    from jamun_tpu_torch.models.e3conv import E3Conv
    from jamun_tpu_torch.ops.cuda import nbr_conv as k6

    small = chain_batch(512, 2, dev)
    ref_model = E3Conv(tensor_product="uvu", dtype=None, device="cpu", plain=True)
    ref_model.load_state_dict(models[torch.float32].state_dict())
    ref_model.requires_grad_(False)
    before = k6.KERNEL.launches
    with torch.no_grad():
        s_cpu = Denoiser(ref_model, config).score(small.to("cpu"), SIGMA)
        s_card = Denoiser(models[torch.float32], config).score(small, SIGMA)
    abs_e, rel_e = rel_err(s_card.cpu(), s_cpu)
    log(f"phase 4: f32 score at N=512, sparse path, K6 on the card vs plain path on the CPU: "
        f"max abs err {abs_e:.3g}, rel {rel_e:.3g} (tol 1e-3)")
    assert rel_e < 1e-3
    q, r = torch.linalg.qr(torch.randn(3, 3, generator=torch.Generator().manual_seed(5)))
    R = (q * torch.sign(torch.diagonal(r))).to(dev)
    if torch.det(R) < 0:
        R = -R
    shift = torch.tensor([0.3, -0.2, 0.5], device=dev)
    mask = small.node_mask[..., None].float()
    out = dict(score_rel_err=rel_e)
    for cdt, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
        d = Denoiser(models[cdt], config)
        with torch.no_grad():
            s = d.score(small, SIGMA)
            s_rot = d.score(small.replace_pos((small.pos @ R.T + shift) * mask), SIGMA)
        err = ((s_rot - (s @ R.T - shift / SIGMA**2) * mask).abs().max() / s.abs().max()).item()
        log(f"phase 4: E(3) check at N=512, sparse path, {str(cdt).split('.')[-1]}: "
            f"|score(Ry+t) - (R score(y) - t/sigma^2)| / max|score| = {err:.3g} (tol {tol})")
        assert err < tol
        out[f"e3_err_{str(cdt).split('.')[-1]}"] = err
    assert k6.KERNEL.launches - before == 5 * 6  # five score calls, six blocks each
    return out


def train_sparse(dev, card: str, kernels: dict) -> dict:
    """Phase 5e: training with the default `neighbor_mode="auto"` at N = 256,
    G = 4 (chain positions), which resolves to the sparse path for a call
    that wants a gradient: the plain sparse path on the card, every kernel's
    launch count 0, a finite loss, the cap's overflow in the logged aux."""
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from jamun_tpu_torch.models.e3conv import E3Conv

    steps, G, N = 5, 4, 256
    model = E3Conv(tensor_product="uvu", dtype=torch.bfloat16, device=dev, seed=0)
    den = Denoiser(model, DenoiserConfig(max_radius=1.0, average_squared_distance=0.5,
                                         add_fixed_noise=True))
    batch = chain_batch(N, G, dev)
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = fit_batches(den, dev, [batch] * steps, max_steps=steps, log_every_n_steps=1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    used = {name: k.launches for name, k in kernels.items()}
    assert state.step == steps and not any(used.values()), used
    train = [m for _, m in metrics if "train/loss" in m]
    losses = [m["train/loss"] for m in train]
    assert len(losses) == steps and all(math.isfinite(v) for v in losses), losses
    overflow = [m["train/neighbor_overflow_max"] for m in train]
    t_at = [(i + 1) / m["train/steps_per_sec"] for i, m in enumerate(train)]
    steady = (t_at[-1] - t_at[0]) * 1e3 / (steps - 1)
    log(f"phase 5: train on the sparse path, G={G} N={N} bf16, \"auto\", plain path on the card: "
        "losses " + " ".join(f"{v:.5f}" for v in losses)
        + f"; {steady:.3f} ms/step over steps 2-{steps}, peak device memory "
        f"{peak / 2**30:.3f} GiB, neighbor_overflow_max {overflow}, kernel launches {used} on {card}")
    return dict(G=G, N=N, steps=steps, losses=losses, ms_per_step_2_to_end=steady,
                peak_bytes=peak, launches=used, neighbor_overflow_max=overflow)


def train_above_128(dev, card: str, kernels: dict) -> dict:
    """Phase 5d: training above 128 atoms. A call that wants a gradient there
    takes the plain path on the card (no kernel launches); the EMA validation
    wants none and takes K5."""
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from jamun_tpu_torch.models.e3conv import E3Conv

    steps, G, N = 5, 4, 256
    model = E3Conv(
        tensor_product="uvu", dtype=torch.bfloat16, neighbor_mode="dense", device=dev, seed=0)
    den = Denoiser(model, DenoiserConfig(max_radius=1.0, average_squared_distance=0.3,
                                         add_fixed_noise=True))
    batch = tiled_batch(N, G, dev)
    before = {name: k.launches for name, k in kernels.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = fit_batches(den, dev, [batch] * steps, max_steps=steps, log_every_n_steps=1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    used = {name: k.launches - before[name] for name, k in kernels.items()}
    assert state.step == steps and not any(used.values()), used
    train = [m for _, m in metrics if "train/loss" in m]
    losses = [m["train/loss"] for m in train]
    assert len(losses) == steps and all(math.isfinite(v) for v in losses), losses
    t_at = [(i + 1) / m["train/steps_per_sec"] for i, m in enumerate(train)]
    steady = (t_at[-1] - t_at[0]) * 1e3 / (steps - 1)
    log(f"phase 5: train above 128 atoms, G={G} N={N} bf16, plain path on the card: losses "
        + " ".join(f"{v:.5f}" for v in losses)
        + f"; {steady:.3f} ms/step over steps 2-{steps}, peak device memory "
        f"{peak / 2**30:.3f} GiB, kernel launches {used} on {card}")
    # the validation forward wants no gradient: K5, six launches
    _, val_metrics = fit_batches(den, dev, [], [batch], max_epochs=1)
    val_used = {name: k.launches - before[name] for name, k in kernels.items()}
    val_loss = [m for _, m in val_metrics if "val/loss" in m][0]["val/loss"]
    log(f"phase 5: validation at N={N}: loss {val_loss:.5f}, launches {val_used}")
    assert math.isfinite(val_loss)
    assert val_used == {**{name: 0 for name in kernels}, "fused_block_tiled": 6}, val_used
    return dict(G=G, N=N, steps=steps, losses=losses, ms_per_step_2_to_end=steady,
                peak_bytes=peak, launches=used, val_loss=val_loss, val_launches=val_used)


def train_flagship(dev, card: str) -> dict:
    """Phase 5b: the training main path, a 20-step Trainer.fit with one EMA
    validation, launch counts zeroed before and read after."""
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from jamun_tpu_torch.models.e3conv import E3Conv
    from jamun_tpu_torch.ops.cuda import conv_block as k2
    from jamun_tpu_torch.ops.cuda import conv_block_bwd as k4
    from jamun_tpu_torch.ops.cuda import edge_features as k1
    from jamun_tpu_torch.ops.cuda import kabsch as kb
    from jamun_tpu_torch.utils.testing import make_test_batch

    steps, G = 20, 32
    model = E3Conv(tensor_product="uvu", dtype=torch.bfloat16, device=dev, seed=0)
    # one fixed noise draw for every step (`add_fixed_noise`): with fresh
    # draws the 20-step trend of the loss at lr 2e-3 is smaller than the
    # draw-to-draw spread, so falling loss would say nothing of the updates
    den = Denoiser(model, DenoiserConfig(max_radius=1.0, average_squared_distance=0.3,
                                         add_fixed_noise=True))
    batch = make_test_batch(num_graphs=G, max_nodes=48, nodes_per_graph=[44] * G, max_bonds=96,
                            device=dev)
    assert den.config.align_noisy_input_during_training  # the default: Kabsch in every batch
    for k in (k1, k2, k4, kb):
        k.KERNEL.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = fit_batches(den, dev, [batch] * steps, [batch], max_steps=steps,
                             log_every_n_steps=1, val_every_n_steps=steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"edge_features": k1.KERNEL.launches, "conv_block": k2.KERNEL.launches,
                "conv_block_bwd": k4.KERNEL.launches, "kabsch": kb.KERNEL.launches}
    train = [m for _, m in metrics if "train/loss" in m]
    val = [m for _, m in metrics if "val/loss" in m]
    losses = [m["train/loss"] for m in train]
    forwards = steps + 1  # every step's forward, and the validation's
    log(f"phase 5: launches {launches} over {steps} steps and {forwards} forwards")
    assert launches == {"edge_features": forwards, "conv_block": 6 * forwards,
                        "conv_block_bwd": 6 * steps, "kabsch": forwards}, launches
    assert len(losses) == steps and all(math.isfinite(v) for v in losses), losses
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log("phase 5: losses " + " ".join(f"{v:.5f}" for v in losses))
    log(f"phase 5: mean loss steps 1-5 {first:.5f}, steps 16-20 {last:.5f}; "
        f"EMA val loss {val[0]['val/loss']:.5f}; grad norms "
        + " ".join(f"{m['train/grad_norm']:.4g}" for m in train))
    assert last < first, (first, last)
    assert len(val) == 1 and math.isfinite(val[0]["val/loss"])
    elapsed = [m["train/steps_per_sec"] for m in train]
    t_at = [(i + 1) / r for i, r in enumerate(elapsed)]  # seconds since the start, synchronised
    steady = (t_at[-1] - t_at[4]) * 1e3 / (steps - 5)
    out = dict(G=G, N=48, atoms=44, steps=steps, seconds=dt, ms_per_step=t_at[-1] * 1e3 / steps,
               ms_per_step_6_to_20=steady, losses=losses, val_loss=val[0]["val/loss"],
               launches=launches)
    log(f"phase 5: train G={G} N=48 bf16: {out['ms_per_step']:.3f} ms/step over {steps} steps, "
        f"{steady:.3f} ms/step over steps 6-20, fit with validation {dt:.3f} s on {card}")
    out["profile"] = profile_steps(den, batch, 3)
    return out


def device_profile(prof, label: str, wall_us: float, top: int) -> dict:
    """Log and return the device's busy time from a torch.profiler trace:
    kernel, memcpy and memset events only. A CPU op's self device time
    repeats the time of the kernels it launched, and a user-annotation
    range (`Optimizer.step#Adam.step`) covers kernels counted already."""
    events = [
        e for e in prof.key_averages()
        if e.device_type != torch.autograd.DeviceType.CPU and not e.is_user_annotation
        and e.self_device_time_total > 0
    ]
    busy_us = sum(e.self_device_time_total for e in events)
    ops = sum(e.count for e in events)
    log(f"profile: {label}, wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {ops} device ops")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    for e in ranked[:top]:
        log(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3, busy_share=busy_us / wall_us,
                device_ops=ops,
                top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in ranked[:top]])


def profile_steps(den, batch, steps: int) -> dict:
    """torch.profiler over a few more train steps (after the counted run)."""
    from torch.profiler import ProfilerActivity, profile

    from jamun_tpu_torch.train.distributions import ConstantSigma
    from jamun_tpu_torch.train.optim import adam
    from jamun_tpu_torch.train.state import create_train_state, make_train_step

    state = create_train_state(den, adam(2.0e-3), seed=1, device=batch.pos.device)
    step = make_train_step(den, ConstantSigma(SIGMA))
    step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return device_profile(prof, f"{steps} train steps", wall_us, 14)


def check_train_gradients(dev) -> float:
    """Phase 5c: f32 gradients of training_loss, kernel path on the card
    against the plain path on the CPU (the same noise: add_fixed_ones)."""
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from jamun_tpu_torch.models.e3conv import E3Conv
    from jamun_tpu_torch.utils.testing import make_test_batch

    config = DenoiserConfig(max_radius=1.0, average_squared_distance=0.3, add_fixed_ones=True)
    card_model = E3Conv(tensor_product="uvu", device=dev, seed=0)
    card_model.output_gain.data.fill_(1.0)
    cpu_model = E3Conv(tensor_product="uvu", device="cpu", plain=True)
    cpu_model.load_state_dict(card_model.state_dict())
    small = make_test_batch(num_graphs=2, max_nodes=44, nodes_per_graph=[44, 41], max_bonds=88,
                            scale=0.35, device=dev)
    grads = []
    for model, batch, d in ((card_model, small, dev), (cpu_model, small.to("cpu"), "cpu")):
        loss, _ = Denoiser(model, config).training_loss(batch, SIGMA, torch.Generator(device=d))
        loss.backward()
        grads.append({  # an unused table (the residue-index embedding) has no gradient
            n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
            for n, p in model.named_parameters()
        })
    errs = {n: rel_err(grads[0][n], g)[1] for n, g in grads[1].items() if g.abs().max() > 0}
    worst = max(errs, key=errs.get)
    log(f"phase 5: f32 training_loss gradients, card kernel path vs CPU plain path: "
        f"{len(errs)} leaves, worst rel err {errs[worst]:.3g} ({worst}) (tol 1e-3)")
    assert errs[worst] < 1e-3, (worst, errs[worst])
    return errs[worst]


def check_walk_never_waits(den, batch, dev, label: str, skin: float = 0.0) -> None:
    """A short walk under PyTorch's sync debug mode set to raise: no step may
    make the host wait for the device (a copy from pageable host memory, an
    `.item()`), or the host could not queue the next forward while the
    kernels of this one run. `skin` > 0 walks on Verlet lists."""
    from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler

    sampler = SingleMeasurementSampler(
        BAOAB(MCMCConfig(delta=0.04, steps=4, score_fn_clip=100.0)), SIGMA, neighbor_skin=skin
    )
    g = torch.Generator(device=dev).manual_seed(6)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sampler.walk_jump(den, batch, batch.pos, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"phase 4: {label} walk: no step makes the host wait for the device")


def profile_walk(den, batch, dev, steps: int, label: str, skin: float = 0.0) -> dict:
    """torch.profiler over a short walk (steps + 1 denoiser forwards)."""
    from torch.profiler import ProfilerActivity, profile

    from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler

    sampler = SingleMeasurementSampler(
        BAOAB(MCMCConfig(delta=0.04, steps=steps, score_fn_clip=100.0)), SIGMA, neighbor_skin=skin
    )
    g = torch.Generator(device=dev).manual_seed(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler.walk_jump(den, batch, batch.pos, g)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = device_profile(prof, f"{label} {steps}-step walk", wall_us, 12)
    out["device_ops_per_forward"] = out["device_ops"] / (steps + 1)
    log(f"profile:   {out['device_ops_per_forward']:.1f} device ops per denoiser forward")
    return out


class BatchTimes:
    """Sampler callback: the seconds each sample batch took, and the
    overflow the sampler reported for it."""

    def __init__(self):
        self.seconds, self.overflow = [], []

    def on_after_sample_batch(self, sample, sampler, elapsed_seconds, neighbor_overflow):
        self.seconds.append(elapsed_seconds)
        self.overflow.append(neighbor_overflow)


def check_samples(samples: list, G: int, N: int, frames: int, label: str) -> None:
    """What `unbatch_samples` returned for one batch: one dict per graph,
    trajectories [atoms, frames, 3] and final states [atoms, 3], all finite."""
    assert len(samples) == G, (label, len(samples))
    for entry in samples:
        assert entry["num_atoms"] == N, (label, entry["num_atoms"])
        for key in ("y_traj", "score_traj", "xhat_traj"):
            assert entry[key].shape == (N, frames, 3), (label, key, entry[key].shape)
        for key in ("y", "v", "xhat", "sample"):
            assert entry[key].shape == (N, 3), (label, key, entry[key].shape)
        for key, value in entry.items():
            if hasattr(value, "shape"):
                assert np.isfinite(value).all(), f"{label}: non-finite {key}"


def stack_walks(den, batches: dict, dev, card: str):
    """Phase 3a: the stack main path through `Sampler.sample`: two continued
    101-step BAOAB batches at 4AA and 2AA, a short ABOBA walk (unfused jump)
    and a chunked host-offload walk at 4AA. Returns the walks' numbers and
    the number of denoiser calls made (one K3 launch each)."""
    from jamun_tpu_torch.sampling.mcmc import ABOBA, BAOAB, MCMCConfig
    from jamun_tpu_torch.sampling.sampler import Sampler
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler

    def cfg(steps):
        return MCMCConfig(delta=0.04, friction=1.0, M=1.0, steps=steps, save_every_n_steps=1,
                          score_fn_clip=100.0)

    walks, calls = {}, 0
    steps, num_batches = 101, 2
    for label in ("4AA", "2AA"):
        batch = batches[label]
        G, N = batch.pos.shape[:2]
        times = BatchTimes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = Sampler(callbacks=[times], device=dev).sample(
            den, SingleMeasurementSampler(BAOAB(cfg(steps)), SIGMA), num_batches, batch,
            continue_chain=True, seed=2,
        )
        dt = time.perf_counter() - t0
        calls += num_batches * (steps + 1)  # initial score, steps - 1 updates, the final jump
        assert len(out) == num_batches
        for samples in out:
            check_samples(samples, G, N, steps, label)
        walk_s = sum(times.seconds)
        walks[f"{label}_stack"] = dict(
            N=N, G=G, steps=steps, batches=num_batches, frames=steps, seconds=dt,
            walk_seconds=times.seconds, ms_per_step=walk_s * 1e3 / (num_batches * steps),
            ms_per_sample=walk_s * 1e3 / (num_batches * G * steps),
        )
        log(f"phase 3: stack walk-jump {label} N={N} G={G}, {num_batches} continued batches of "
            f"{steps} steps through Sampler.sample: walks {walk_s:.3f} s "
            f"({' '.join(f'{t:.3f}' for t in times.seconds)}), with unbatching {dt:.3f} s, "
            f"{walks[f'{label}_stack']['ms_per_sample']:.6f} ms/sample, "
            f"{walks[f'{label}_stack']['ms_per_step']:.3f} ms/step on {card}")

    batch = batches["4AA"]
    G, N = batch.pos.shape[:2]
    # ABOBA: the saved score is the midpoint's, so every frame is jumped again
    steps, per_call = 11, 4
    out = Sampler(device=dev).sample(
        den, SingleMeasurementSampler(ABOBA(cfg(steps)), SIGMA, jump_chunk_size=per_call), 1,
        batch, seed=3,
    )
    check_samples(out[0], G, N, steps, "ABOBA")
    calls += 1 + (steps - 1) + 1 + math.ceil(steps / per_call)  # frame 0, updates, final, jumps
    log(f"phase 3: ABOBA 4AA {steps} steps, unfused jump {per_call} frames per call: ok")
    # host offload: 40 updates in chunks of 16, 16 and 8, frames on the grid of 41
    steps, chunk = 41, 16
    out = Sampler(device=dev).sample(
        den, SingleMeasurementSampler(BAOAB(cfg(steps)), SIGMA, offload_chunk_steps=chunk), 1,
        batch, seed=4,
    )
    check_samples(out[0], G, N, steps, "chunked")
    n_chunks = math.ceil((steps - 1) / chunk)
    calls += (steps - 1) + 2 * n_chunks  # every update, and a first score and a jump per chunk
    log(f"phase 3: chunked 4AA {steps} steps, offload every {chunk}: {steps} frames on the grid: ok")
    return walks, calls


def dense_conv_cost(x, pos, n_pairs: int, out, deg, weights, cdt):
    """(flops, bytes) K8 and K9 need on these inputs: the radial MLP and the
    messages of the visited pairs; x, the positions and mask, the weights,
    the output and the degree once each."""
    G, N, F = x.shape
    W = weights[2].shape[-1]
    flops = 2 * n_pairs * (32 * 64 + 64 * W)
    nbytes = (
        x.numel() * x.element_size() + pos.numel() * 4 + G * N
        + sum(t.numel() * t.element_size() for t in weights)
        + out.numel() * 4 + deg.numel() * 4
    )
    return flops, nbytes


def check_dense_conv(k89, models, batches, dev, c_in: float, cutoff: float, shapes=None) -> list:
    """Phase 2, K8 and K9: the dense messages from the positions against
    their plain versions, bf16 and f32, at the flagship hidden width
    (S = 120, V = 32) at 4AA (N = 44, G = 256), 5AA (N = 112, G = 128),
    N = 256, G = 16 and N = 1500, G = 2 (where the bf16 build walks the
    sources in passes), and K8 at the projector's width (S = 56, V = 0) at
    4AA and 5AA. The degree must equal the plain version's on every atom,
    and K9 must equal K8 bit for bit. The bounds count the visited pairs
    only."""
    shapes = shapes or {"4AA": batches["4AA"], "5AA": batches["5AA"], "N256": tiled_batch(256, 16, dev),
                        "passes": tiled_batch(1500, 2, dev, [1500, 1400])}
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for label, batch in shapes.items():
        G, N = batch.pos.shape[:2]
        pos = (batch.pos * c_in).contiguous()
        for cdt in (torch.bfloat16, torch.float32):
            model = models[cdt]
            bond0 = model.embed_bondedness[0]
            blocks = [("hidden", model._HiddenLayer_0.ConvBlock_0, 120, 32)]
            if label in ("4AA", "5AA"):
                blocks.append(("projector", model.ConvBlock_0, 56, 0))
            for block_name, blk, S, V in blocks:
                tag = f"{block_name} {label} N={N} G={G} {str(cdt).split('.')[-1]}"
                d0, d1 = blk.Conv_0.radial_nn.layer(0), blk.Conv_0.radial_nn.layer(1)
                x = torch.randn((G, N, S + 3 * V), generator=gen, device=dev).to(cdt)
                args = (pos, batch.node_mask, x, d0.kernel, d0.bias, d1.kernel, d1.bias, bond0,
                        cutoff, S, V)
                got, deg = k89.packed_uvu_conv_dense(*args)
                want, deg_p = k89.packed_uvu_conv_dense_plain(*args)
                torch.cuda.synchronize()
                assert torch.isfinite(got).all(), f"K8 {tag}: non-finite output"
                deg_mismatch = int((deg != deg_p).sum())
                assert deg_mismatch == 0, f"K8 {tag}: the degree differs on {deg_mismatch} atoms"
                abs_e, rel_e = rel_err(got, want)
                assert rel_e <= TOL[cdt], f"K8 {tag}: rel err {rel_e:.3g} > {TOL[cdt]}"
                n_pairs = int(deg.sum(dtype=torch.float64))
                weights = k89.dense_weights(d0.kernel, d0.bias, d1.kernel, d1.bias, bond0, cdt)
                flops, nbytes = dense_conv_cost(x, pos, n_pairs, got, deg, weights, cdt)
                t_ops = flops / PEAK_FLOPS[cdt] * 1e3
                t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
                real = batch.node_mask.sum(-1).double()
                occ = k89.occupancy(N, S, V, cdt)
                assert occ["smem_bytes"] == k89.layout(N, S, V, cdt)["smem_bytes"], (tag, occ)
                common = dict(
                    max_abs_err=abs_e, max_rel_err=rel_e, tol=TOL[cdt],
                    plain_ms=cuda_time_ms(lambda: k89.packed_uvu_conv_dense_plain(*args), 1),
                    bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                    visited_pairs=n_pairs, share_inside_cutoff=n_pairs / float((real * (real - 1)).sum()),
                    flops=flops, bytes=nbytes, dtype=str(cdt), N=N, G=G, block=block_name, label=label,
                    registers=occ["registers"], spill_bytes=occ["spill_bytes"],
                    ctas_per_sm=occ["ctas_per_sm"], smem_bytes=occ["smem_bytes"],
                    atoms_per_cta=occ["atoms_per_cta"], sources_per_pass=occ["sources_per_pass"],
                )
                rows.append(dict(kernel="packed_uvu_conv_dense", shape=f"K8 {tag}",
                                 ms=cuda_time_ms(lambda: k89.packed_uvu_conv_dense(*args), 10),
                                 prev_ms=PREV_MS.get(("packed_uvu_conv_dense", f"K8 {tag}")), **common))
                msg = f"K8 {rows[-1]['ms']:.4f} ms"
                if V:
                    got9, deg9 = k89.fused_uvu_conv_dense(*args)
                    torch.cuda.synchronize()
                    assert torch.equal(got9, got) and torch.equal(deg9, deg), f"K9 {tag}: differs from K8"
                    rows.append(dict(kernel="fused_uvu_conv_dense", shape=f"K9 {tag}",
                                     ms=cuda_time_ms(lambda: k89.fused_uvu_conv_dense(*args), 10),
                                     prev_ms=PREV_MS.get(("fused_uvu_conv_dense", f"K9 {tag}")),
                                     **common))
                    msg += f", K9 {rows[-1]['ms']:.4f} ms (equal to K8 bit for bit)"
                prev = [r["prev_ms"] for r in rows[-(2 if V else 1):] if r["prev_ms"] is not None]
                if prev:
                    msg += " (before the redesign: " + ", ".join(f"{t:.4f}" for t in prev) + " ms)"
                log(f"phase 2: K8/K9 {tag}: max abs err {abs_e:.3g}, rel {rel_e:.3g} (tol {TOL[cdt]}), "
                    f"degree equal on all atoms; {msg}, plain {common['plain_ms']:.4f} ms, bound "
                    f"{common['bound_ms']:.4f} ms ({common['bound_by']}), {n_pairs} visited pairs "
                    f"({100 * common['share_inside_cutoff']:.1f}% of the ordered pairs); "
                    f"{occ['smem_bytes']} B shared, {occ['atoms_per_cta']} atoms per CTA, "
                    f"{occ['sources_per_pass']} sources per pass, {occ['registers']} registers, "
                    f"{occ['spill_bytes']} spill bytes, {occ['ctas_per_sm']} CTAs per SM")
                del got, want, deg, deg_p
                torch.cuda.empty_cache()
    return rows


def check_conv_layer(k1, k2, models, batches, dev, c_in: float, cutoff: float) -> list:
    """Phase 2, K2's layer mode against its plain version on the flagship
    hidden block's Conv_0 (irreps_out 120x0e + 32x0e + 32x1e, the fused
    layer's shape) at 4AA and 5AA, bf16 and f32, on K1's features."""
    gen = torch.Generator(device=dev).manual_seed(10)
    rows = []
    for label in ("4AA", "5AA"):
        batch = batches[label]
        G, N = batch.pos.shape[:2]
        pos = (batch.pos * c_in).contiguous()
        geo = (pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask, cutoff, 32)
        for cdt in (torch.bfloat16, torch.float32):
            tag = f"hidden {label} N={N} G={G} {str(cdt).split('.')[-1]}"
            model = models[cdt]
            conv = model._HiddenLayer_0.ConvBlock_0.Conv_0
            ef, bf = k1.edge_features(*geo, cdt)
            w = k2.layer_weights(conv.radial_nn, conv._post_linear, model.embed_bondedness[0],
                                 model.embed_bondedness[1], S=120, V=32, cdt=cdt)
            x = torch.randn((G, N, 216), generator=gen, device=dev).to(cdt)
            args = (x, ef, bf, batch.bond_src, batch.bond_dst, w)
            got = k2.conv_layer(*args)
            want = k2.conv_layer_plain(*args)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), f"K2 layer {tag}: non-finite output"
            abs_e, rel_e = rel_err(got, want)
            assert rel_e <= TOL[cdt], f"K2 layer {tag}: rel err {rel_e:.3g} > {TOL[cdt]}"
            n_dense = int(ef[..., 3].sum(dtype=torch.float32))
            n_pairs = n_dense + int(bf[..., 3].sum(dtype=torch.float32))
            Wd, C0, V1 = 2 * 120 + 3 * 32, w.C0, w.V1
            flops = 2 * n_pairs * (32 * 64 + 64 * Wd) + 2 * G * N * (152 * C0 + 3 * 184 * V1)
            nbytes = (
                (x.numel() + bf.numel()) * x.element_size() + ef_bytes(ef, n_dense)
                + batch.bond_src.numel() * 16 + got.numel() * 4
                + sum(t.numel() * t.element_size() for t in w if torch.is_tensor(t))
            )
            t_ops = flops / PEAK_FLOPS[cdt] * 1e3
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            occ = k2.occupancy(N, batch.bond_src.shape[1], 120, 32, C0, V1, cdt, layer=True)
            row = dict(
                shape=f"K2 layer {tag}", max_abs_err=abs_e, max_rel_err=rel_e, tol=TOL[cdt],
                ms=cuda_time_ms(lambda: k2.conv_layer(*args), 10),
                prev_ms=PREV_MS[("conv_layer", f"K2 layer {tag}")],
                plain_ms=cuda_time_ms(lambda: k2.conv_layer_plain(*args), 2),
                bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                visited_pairs=n_pairs, flops=flops, bytes=nbytes, dtype=str(cdt), N=N, G=G,
                block="hidden", label=label, registers=occ["registers"],
                spill_bytes=occ["spill_bytes"], ctas_per_sm=occ["ctas_per_sm"],
                smem_bytes=occ["smem_bytes"],
            )
            rows.append(row)
            log(f"phase 2: K2 layer mode {tag}: max abs err {abs_e:.3g}, rel {rel_e:.3g} "
                f"(tol {TOL[cdt]}); kernel {row['ms']:.4f} ms (before the redesign: {row['prev_ms']:.4f}), "
                f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"{n_pairs} visited pairs; {occ['registers']} registers, {occ['smem_bytes']} B shared, "
                f"{occ['ctas_per_sm']} CTAs per SM")
            del got, want, ef, bf
            torch.cuda.empty_cache()
    return rows


def plane_walks(den, batches: dict, dev, card: str, counters: dict):
    """Phase 3e: walk-jump with `E3Conv(pallas_variant="plane")` at full
    flagship width through `Sampler.sample`, BAOAB, 101 steps: 4AA (N = 44,
    G = 256) and 5AA (N = 112, G = 128), the layerwise walks' batches and
    step count. Every launch count is set to 0 just before each walk and read
    just after: K9 five times per denoiser call (the hidden layers; the
    projector runs the plain path, V = 0), every other kernel never. Returns
    the walks' numbers and K9's launches in them."""
    from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
    from jamun_tpu_torch.sampling.sampler import Sampler
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler

    walks, launched, steps = {}, 0, 101
    cfg = MCMCConfig(delta=0.04, friction=1.0, M=1.0, steps=steps, save_every_n_steps=1,
                     score_fn_clip=100.0)
    for label in ("4AA", "5AA"):
        batch = batches[label]
        G, N = batch.pos.shape[:2]
        times = BatchTimes()
        for k in counters.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = Sampler(callbacks=[times], device=dev).sample(
            den, SingleMeasurementSampler(BAOAB(cfg), SIGMA), 1, batch, seed=2,
        )
        dt = time.perf_counter() - t0
        used = {name: k.launches for name, k in counters.items()}
        want = {**dict.fromkeys(counters, 0), "fused_uvu_conv_dense": 5 * (steps + 1)}
        assert used == want, (label, used, want)
        launched += used["fused_uvu_conv_dense"]
        check_samples(out[0], G, N, steps, f"plane {label}")
        walk_s = sum(times.seconds)
        walks[f"{label}_plane"] = dict(
            N=N, G=G, steps=steps, frames=steps, seconds=dt, walk_seconds=walk_s,
            ms_per_step=walk_s * 1e3 / steps, ms_per_sample=walk_s * 1e3 / (G * steps),
            launches=used,
        )
        log(f"phase 3: plane walk-jump {label} N={N} G={G} steps={steps} through Sampler.sample: "
            f"walk {walk_s:.3f} s, with unbatching {dt:.3f} s, "
            f"{walks[f'{label}_plane']['ms_per_sample']:.6f} ms/sample, "
            f"{walks[f'{label}_plane']['ms_per_step']:.3f} ms/step on {card}; "
            f"K9 {used['fused_uvu_conv_dense']} launches, every other kernel none")
    return walks, launched


def conv_level_calls(models, batch, dev, c_in: float, cutoff: float, counters: dict) -> dict:
    """Phase 3f: `Conv` calls that reach K8 and K2's layer mode through the
    Conv-level dispatch, at the flagship hidden width on the 4AA batch: a
    `Conv` whose irreps_out is 32x1e (no 0e block, so not the fused layer:
    K8), one at V = 0 (the projector's 56x0e input) on edges without the
    bondedness-1 row (K8), and the hidden block's shape with both rows (K2's
    layer mode, with K1's features made in the call). Counts zeroed before
    each call and read after; each output is held against the plain path on
    the card in f32 (1e-4) and is finite in bf16."""
    import functools as ft

    from jamun_tpu_torch.ops.conv import Conv
    from jamun_tpu_torch.ops.graph import dense_edge_data
    from jamun_tpu_torch.ops.sh import spherical_harmonics

    gen = torch.Generator().manual_seed(12)
    scaled = batch.replace_pos((batch.pos * c_in).contiguous())
    cases = (
        ("K8, irreps_out 32x1e", "120x0e + 32x1e", "32x1e", True, "packed_uvu_conv_dense"),
        ("K8, V = 0, no bondedness-1 row", "56x0e", "120x0e + 32x0e + 32x1e", False,
         "packed_uvu_conv_dense"),
        ("K2 layer mode", "120x0e + 32x1e", "120x0e + 32x0e + 32x1e", True, "conv_layer"),
    )
    out = {}
    for label, irreps_in, irreps_out, bond1, kernel in cases:
        for cdt in (torch.bfloat16, torch.float32):
            model = models[cdt]
            conv = Conv(irreps_in, irreps_out, "1x0e + 1x1e", 64, dtype=cdt).to(dev)
            for prm in conv.parameters():
                prm.data.copy_(torch.randn(prm.shape, generator=gen) / 4)
            conv.requires_grad_(False)
            edges = dense_edge_data(
                scaled.pos, scaled.node_mask, scaled.bond_src, scaled.bond_dst, scaled.bond_mask,
                cutoff, ft.partial(spherical_harmonics, "1x0e + 1x1e"), model._attr_fn(cutoff),
                bond0_embed=model.embed_bondedness[0],
                bond1_embed=model.embed_bondedness[1] if bond1 else None,
            )
            x = torch.randn((*batch.pos.shape[:2], conv.irreps_in.dim), generator=gen).to(dev, cdt)
            for k in counters.values():
                k.launches = 0
            with torch.no_grad():
                got = conv(x, edges, kernel=True)
                torch.cuda.synchronize()
                used = {name: k.launches for name, k in counters.items() if k.launches}
                plain = conv(x, edges)
            want = {kernel: 1, **({"edge_features": 1} if kernel == "conv_layer" else {})}
            assert used == want, (label, used, want)
            assert torch.isfinite(got).all(), label
            tag = f"{label} {str(cdt).split('.')[-1]}"
            err = rel_err(got, plain)[1]
            if cdt == torch.float32:
                assert err < 1e-4, (tag, err)
            out[tag] = dict(launches=used, rel_err_vs_plain=err)
            log(f"phase 3: Conv-level call, {tag}: launches {used}; vs the plain path on the card "
                f"rel {err:.3g}" + (" (tol 1e-4)" if cdt == torch.float32 else ""))
    return out


def check_plane_score(plane_models: dict, config, dev) -> dict:
    """Phase 4 on the plane path: the f32 score on the 4AA-sized batch
    (G = 2 of 44 and 41 atoms) on the card (K9) against the plain path on the
    CPU, and E(3) equivariance in f32 and bf16."""
    from jamun_tpu_torch.models.denoiser import Denoiser
    from jamun_tpu_torch.models.e3conv import E3Conv
    from jamun_tpu_torch.ops.cuda import dense_conv as k89
    from jamun_tpu_torch.utils.testing import make_test_batch

    small = make_test_batch(num_graphs=2, max_nodes=44, nodes_per_graph=[44, 41], max_bonds=88,
                            scale=0.35, device=dev)
    ref_model = E3Conv(tensor_product="uvu", dtype=None, device="cpu", plain=True)
    ref_model.load_state_dict(plane_models[torch.float32].state_dict())
    ref_model.requires_grad_(False)
    before = k89.K9.launches
    with torch.no_grad():
        s_cpu = Denoiser(ref_model, config).score(small.to("cpu"), SIGMA)
        s_card = Denoiser(plane_models[torch.float32], config).score(small, SIGMA)
    abs_e, rel_e = rel_err(s_card.cpu(), s_cpu)
    log(f"phase 4: f32 score at 4AA, plane path (K9) on the card vs plain path on the CPU: "
        f"max abs err {abs_e:.3g}, rel {rel_e:.3g} (tol 1e-3)")
    assert rel_e < 1e-3
    q, r = torch.linalg.qr(torch.randn(3, 3, generator=torch.Generator().manual_seed(5)))
    R = (q * torch.sign(torch.diagonal(r))).to(dev)
    if torch.det(R) < 0:
        R = -R
    shift = torch.tensor([0.3, -0.2, 0.5], device=dev)
    mask = small.node_mask[..., None].float()
    out = dict(score_rel_err=rel_e)
    for cdt, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
        d = Denoiser(plane_models[cdt], config)
        with torch.no_grad():
            s = d.score(small, SIGMA)
            s_rot = d.score(small.replace_pos((small.pos @ R.T + shift) * mask), SIGMA)
        err = ((s_rot - (s @ R.T - shift / SIGMA**2) * mask).abs().max() / s.abs().max()).item()
        log(f"phase 4: E(3) check at 4AA, plane path, {str(cdt).split('.')[-1]}: "
            f"|score(Ry+t) - (R score(y) - t/sigma^2)| / max|score| = {err:.3g} (tol {tol})")
        assert err < tol
        out[f"e3_err_{str(cdt).split('.')[-1]}"] = err
    assert k89.K9.launches - before == 5 * 5  # five score calls, five hidden layers each
    return out


def check_train_never_waits(dev) -> dict:
    """Phase 4: `Trainer.fit` under PyTorch's sync debug mode set to raise:
    three steps from host batches (pinned, copied without blocking), with a
    mirror flip drawn at every step, one fixed noise draw and the Kabsch
    alignment of the noisy input (`align_noisy_input_during_training`, on
    by default), the three host waits the training step used to make. Each
    step aligns once, on the Kabsch kernel."""
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from jamun_tpu_torch.models.e3conv import E3Conv
    from jamun_tpu_torch.ops.cuda import kabsch as kb
    from jamun_tpu_torch.train.distributions import ConstantSigma
    from jamun_tpu_torch.train.loop import Trainer, TrainerConfig
    from jamun_tpu_torch.train.optim import adam
    from jamun_tpu_torch.utils.testing import FixedBatches, RecordingLogger, make_test_batch

    model = E3Conv(tensor_product="uvu", dtype=torch.bfloat16, device=dev, seed=0)
    den = Denoiser(model, DenoiserConfig(
        max_radius=1.0, average_squared_distance=0.3, mirror_augmentation_rate=0.5,
        add_fixed_noise=True,
    ))
    assert den.config.align_noisy_input_during_training
    host = make_test_batch(num_graphs=32, max_nodes=48, nodes_per_graph=[44] * 32, max_bonds=96,
                           device="cpu")
    fit_batches(den, dev, [host], max_steps=3, log_every_n_steps=1000)  # the cached constants
    tmp = tempfile.TemporaryDirectory()
    cfg = TrainerConfig(max_steps=3, log_every_n_steps=1000, seed=0,
                        checkpoint_dir=os.path.join(tmp.name, "checkpoints"))
    trainer = Trainer(cfg, RecordingLogger(), device=dev)
    before = kb.KERNEL.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = trainer.fit(den, adam(2.0e-3), ConstantSigma(SIGMA), FixedBatches([host] * 3))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tmp.cleanup()
    aligned = kb.KERNEL.launches - before
    assert state.step == 3 and aligned == 3, (state.step, aligned)
    log(f"phase 4: Trainer.fit with the alignment, 3 steps from host batches: no step makes the "
        f"host wait for the device ({dt * 1e3 / 3:.3f} ms/step with fit's set-up); "
        f"Kabsch launches {aligned}")
    return dict(steps=3, ms_per_step_with_setup=dt * 1e3 / 3, kabsch_launches=aligned)


# phase 6: four uncapped tetrapeptides for training and two for validation,
# each 33-48 heavy atoms, so that every graph pads to the 48-atom bucket
CLI_TRAIN_SEQS = ("KWFE", "RYLD", "MHQT", "WYRK")
CLI_VAL_SEQS = ("FNEY", "LKWS")
CLI_FRAMES = 200
CLI_STEPS, CLI_VAL_EVERY, CLI_RESUME_STEPS = 30, 15, 5
CLI_PROFILED = (19, 29)  # the CLI's steps 19-28 profiled: between its two validations


def write_4aa_dataset(root: str, seed: int = 0) -> dict:
    """The Timewarp layout `timewarp/4AA-large/{train,val}/<seq>-traj-arrays.npz`
    and `<seq>-traj-state0.pdb`: `build_peptide`'s structure and 200 frames
    of it plus N(0, 0.02 nm) noise from a seeded generator. Returns each
    sequence's heavy-atom count."""
    from jamun_tpu_torch.data.peptide_builder import build_peptide
    from jamun_tpu_torch.data.topology import save_pdb

    rng = np.random.default_rng(seed)
    atoms = {}
    for split, seqs in (("train", CLI_TRAIN_SEQS), ("val", CLI_VAL_SEQS)):
        out = os.path.join(root, "timewarp", "4AA-large", split)
        os.makedirs(out, exist_ok=True)
        for seq in seqs:
            top, pos = build_peptide(seq)
            frames = pos[None] + rng.normal(0.0, 0.02, (CLI_FRAMES,) + pos.shape)
            save_pdb(os.path.join(out, f"{seq}-traj-state0.pdb"), top, pos)
            np.savez(os.path.join(out, f"{seq}-traj-arrays.npz"), positions=frames.astype(np.float32))
            atoms[seq] = len(top.atoms)
    return atoms


def read_metrics_csv(path: str):
    """(train rows, val rows) of a run's metrics.csv, values as floats."""
    import csv

    with open(path) as f:
        rows = [{k: float(v) for k, v in r.items() if v != ""} for r in csv.DictReader(f)]
    return [r for r in rows if "train/loss" in r], [r for r in rows if "val/loss" in r]


def cli_score_check(run_dir: str, batch, dev) -> float:
    """The run's trained weights (last.ckpt) in f32: the score of the arch
    on the card against the same score on the CPU plain path, relative to
    the max."""
    import pickle

    from jamun_tpu_torch.cmdline.common import build_denoiser

    with open(os.path.join(run_dir, "config.pkl"), "rb") as f:
        cfg = pickle.load(f)  # written by this run's CLI
    params = torch.load(os.path.join(run_dir, "checkpoints", "last.ckpt"), weights_only=True)["params"]
    # E3Conv's CPU reference is its plain path; Ophiuchus has only that path
    plain = {"plain": True} if "E3Conv" in cfg["model"]["arch"]["_target_"] else {}
    scores = []
    for device, extra in ((dev, {}), ("cpu", plain)):
        model_cfg = dict(cfg["model"], arch=dict(cfg["model"]["arch"], dtype=None, **extra))
        den = build_denoiser(model_cfg, device=device, seed=0)
        den.arch.load_state_dict(params)
        den.arch.requires_grad_(False)
        with torch.no_grad():
            scores.append(den.score(batch.to_device(device), SIGMA).cpu())
    return rel_err(scores[0], scores[1])[1]


def check_restore_bits(run_dir: str, dev) -> int:
    """`restore_checkpoint` of the run's last.ckpt into a fresh state: every
    parameter, EMA parameter and optimizer tensor equal to the saved one bit
    for bit, the step count and the generators too. Returns the step."""
    import pickle

    from jamun_tpu_torch.cmdline.common import build_denoiser, build_optimizer
    from jamun_tpu_torch.train.checkpoints import restore_checkpoint
    from jamun_tpu_torch.train.state import create_train_state

    with open(os.path.join(run_dir, "config.pkl"), "rb") as f:
        cfg = pickle.load(f)  # written by this run's CLI
    path = os.path.join(run_dir, "checkpoints", "last.ckpt")
    saved = torch.load(path, weights_only=True)
    state = create_train_state(build_denoiser(cfg["model"], device=dev, seed=1),
                               build_optimizer(cfg["model"]), seed=1, device=dev)
    restore_checkpoint(path, state)

    def same(a, b, where):
        if torch.is_tensor(a):
            assert torch.equal(a.cpu(), b.cpu()), where
        elif isinstance(a, dict):
            assert sorted(a) == sorted(b), where
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        else:
            assert a == b, (where, a, b)

    same(saved["params"], state.module.state_dict(), "params")
    same(saved["ema_params"], state.ema.state_dict(), "ema_params")
    same(saved["opt_state"], state.optimizer.state_dict(), "opt_state")
    same(saved["generator"], state.generator.get_state(), "generator")
    same(saved["host_generator"], state.host_generator.get_state(), "host_generator")
    assert state.step == saved["step"]
    return state.step


@contextlib.contextmanager
def profile_cli_steps(first: int, stop: int):
    """torch.profiler over the CLI's own `Trainer.fit`, from the start of
    train step `first` to the start of step `stop`, so that the window holds
    whatever the fit does between its steps (the DataModule's batches, the
    logged read, the loggers); each end is a synchronize. Wraps the step
    function that `train/loop.py` builds; yields a dict that holds the
    window's `device_profile` once the fit has passed step `stop`."""
    from torch.profiler import ProfilerActivity, profile

    from jamun_tpu_torch.train import loop

    make = loop.make_train_step
    out, live = {}, {}

    def make_profiled(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(state, batch):
            if state.step + 1 == first:
                torch.cuda.synchronize()
                live["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                live["prof"].start()
                live["t0"] = time.perf_counter()
            elif state.step + 1 == stop and live:
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - live["t0"]) * 1e6
                live["prof"].stop()
                out.update(device_profile(
                    live.pop("prof"), f"the CLI's train steps {first}-{stop - 1}", wall_us, 14))
                out["ms_per_step"] = wall_us / 1e3 / (stop - first)
                live.clear()
            return step(state, batch)

        return run

    loop.make_train_step = make_profiled
    try:
        yield out
    finally:
        loop.make_train_step = make
        if live:
            live["prof"].stop()


EXP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "experiment")


def cli_val_dir(work: str) -> str:
    return os.path.join(work, "data", "timewarp", "4AA-large", "val")


def cli_score_batch(work: str):
    """Three fixed validation frames of the 4AA dataset, one host batch."""
    from jamun_tpu_torch.data.batching import collate
    from jamun_tpu_torch.data.discovery import parse_datasets_from_directory

    val_sets = parse_datasets_from_directory(
        cli_val_dir(work), "^(.*)-traj-arrays.npz", "^(.*)-traj-state0.pdb")
    return collate([val_sets[0][0], val_sets[0][7], val_sets[1][3]])


@contextlib.contextmanager
def cli_workdir():
    """A temporary work directory for phases 6 and 7, with the 4AA dataset
    written into it, `JAMUN_DATA_PATH` pointing there and the process in it;
    all three undone (the directory removed) on the way out. Yields the
    directory and each sequence's heavy-atom count."""
    cwd, env = os.getcwd(), os.environ.get("JAMUN_DATA_PATH")
    tmp = tempfile.TemporaryDirectory()
    try:
        atoms = write_4aa_dataset(os.path.join(tmp.name, "data"))
        os.environ["JAMUN_DATA_PATH"] = os.path.join(tmp.name, "data")
        os.chdir(tmp.name)
        log(f"phase 6: wrote a 4AA dataset: train {CLI_TRAIN_SEQS}, val {CLI_VAL_SEQS}, "
            f"{CLI_FRAMES} frames each, heavy atoms {atoms}")
        yield tmp.name, atoms
    finally:
        os.chdir(cwd)
        if env is None:
            os.environ.pop("JAMUN_DATA_PATH", None)
        else:
            os.environ["JAMUN_DATA_PATH"] = env
        tmp.cleanup()


def train_cli_runs(dev, card: str, counters: dict, kabsch_kernel, work: str, atoms: dict) -> dict:
    """Phase 6: the training CLI, `jamun_tpu_torch.cmdline.train.main`, in
    process in `work` (`cli_workdir`) on its 4AA dataset: the repo's
    `experiment=train_uncapped_4AA` at its full width (uvw, 120x0e + 32x1e,
    5 layers, batch 32), then the same with `model/arch=e3conv_separable`
    (uvu, bf16, kernels on), then a resume of the uvw run from last.ckpt."""
    import statistics

    from jamun_tpu_torch.cmdline import train as train_cli

    score_batch = cli_score_batch(work)
    out = {}
    base = ["--experiment-dir", EXP_DIR, "experiment=train_uncapped_4AA",
            f"trainer.max_steps={CLI_STEPS}", f"trainer.val_every_n_steps={CLI_VAL_EVERY}",
            "trainer.log_every_n_steps=1"]
    path_kernels = ("edge_features", "conv_block", "conv_block_bwd")
    for label, run_key, extra in (
        ("uvw", "train_uncapped_4AA", []),
        ("separable", "train_uncapped_4AA_separable",
         ["model/arch=e3conv_separable", "run_key=train_uncapped_4AA_separable"]),
    ):
        for k in (*counters.values(), kabsch_kernel):
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with profile_cli_steps(*CLI_PROFILED) as prof:
            state = train_cli.main([*base, *extra])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {name: k.launches for name, k in counters.items()}
        kabsch = kabsch_kernel.launches
        run_dir = os.path.join("runs", run_key)
        train, val = read_metrics_csv(os.path.join(run_dir, "metrics.csv"))
        losses = [r["train/loss"] for r in train]
        # each step's gap from the row before; the profiled steps (and the
        # profiler's start and stop, inside steps 19 and 29) left out
        gaps = [(b["time"] - a["time"]) * 1e3 for a, b in zip(train, train[1:])
                if not CLI_PROFILED[0] <= b["step"] <= CLI_PROFILED[1]]
        ms_step = statistics.median(gaps)
        G, N = 32, 48
        assert state.step == CLI_STEPS
        assert [r["step"] for r in train] == list(range(1, CLI_STEPS + 1))
        assert [r["step"] for r in val] == [CLI_VAL_EVERY, CLI_STEPS], val
        assert all(math.isfinite(v) for v in losses + [r["val/loss"] for r in val])
        assert losses[-1] < losses[0], (losses[0], losses[-1])
        assert kabsch > 0  # align_noisy_input_during_training is on in both configs
        if label == "uvw":
            assert state.module.tensor_product == "uvw" and not any(
                launches[k] for k in path_kernels), launches
        else:
            assert state.module.tensor_product == "uvu" and all(
                launches[k] > 0 for k in path_kernels), launches
        score_err = cli_score_check(run_dir, score_batch, dev)
        assert score_err < 1e-3, (label, score_err)
        assert prof, "the profiled window of the CLI's fit did not close"
        out[label] = dict(
            run_key=run_key, steps=CLI_STEPS, seconds=seconds, ms_per_step=ms_step,
            peak_bytes=peak, first_loss=losses[0], last_loss=losses[-1],
            val_loss=[r["val/loss"] for r in val], atoms=atoms, bucket=N, batch=G,
            launches=launches, kabsch_launches=kabsch, score_rel_err=score_err, profile=prof,
        )
        log(f"phase 6: {label} ({run_key}): {ms_step:.3f} ms/step (median over steps 2-"
            f"{CLI_PROFILED[0] - 1} and {CLI_PROFILED[1] + 1}-{CLI_STEPS}, host clock after "
            f"each step's logged read), peak device memory "
            f"{peak / 2**30:.3f} GiB, train loss {losses[0]:.5f} -> {losses[-1]:.5f}, val loss "
            + " ".join(f"{r['val/loss']:.5f}" for r in val)
            + f"; N {min(atoms.values())}-{max(atoms.values())} atoms, bucket {N}, batch {G}; "
            f"launches {launches}, Kabsch {kabsch}; f32 score card vs CPU rel err "
            f"{score_err:.3g} (tol 1e-3); device busy {100 * prof['busy_share']:.1f}% of the CLI's "
            f"steps {CLI_PROFILED[0]}-{CLI_PROFILED[1] - 1} under the profiler "
            f"({prof['ms_per_step']:.3f} ms/step there); "
            f"{seconds:.1f} s in main on {card}")

    # resume the uvw run for five more steps from its last.ckpt
    run_dir = os.path.join("runs", "train_uncapped_4AA")
    restored = check_restore_bits(run_dir, dev)
    assert restored == CLI_STEPS
    ckpt = os.path.join(run_dir, "checkpoints", "last.ckpt")
    state = train_cli.main([*base, f"trainer.max_steps={CLI_STEPS + CLI_RESUME_STEPS}",
                            f"trainer.val_every_n_steps={CLI_RESUME_STEPS}",
                            f"resume_from_checkpoint={os.path.abspath(ckpt)}"])
    train, val = read_metrics_csv(os.path.join(run_dir, "metrics.csv"))
    with open(os.path.join(run_dir, "checkpoints", "manifest.json")) as f:
        manifest = json.load(f)
    steps = sorted(e["step"] for e in manifest["entries"])
    assert state.step == CLI_STEPS + CLI_RESUME_STEPS
    assert [r["step"] for r in train] == list(
        range(CLI_STEPS + 1, CLI_STEPS + CLI_RESUME_STEPS + 1))
    assert steps == [CLI_VAL_EVERY, CLI_STEPS, CLI_STEPS + CLI_RESUME_STEPS], steps
    assert torch.load(ckpt, weights_only=True)["step"] == CLI_STEPS + CLI_RESUME_STEPS
    out["resume"] = dict(restored_step=restored, final_step=state.step, manifest_steps=steps,
                         losses=[r["train/loss"] for r in train])
    log(f"phase 6: resume from last.ckpt at step {restored}: parameters, EMA, optimizer state "
        f"and generators restored bit for bit; trained on to step {state.step} "
        f"(steps {train[0]['step']:.0f}-{train[-1]['step']:.0f} logged); the manifest's top-k "
        f"lists steps {steps}")
    return out


# phase 7: the sample CLI on phase 6's runs, `experiment=sample_uncapped_4AA`
# on the 4AA validation split (two tetrapeptides, the 48-atom bucket); only
# run lengths and chain counts are cut (`SAMPLE_RUNS`: the config's 20000
# steps x 5 batches, 1 chain per peptide)
SAMPLE_RUNS = {
    # label: (train run key, repeat_init_samples, num_batches, steps per batch, extra overrides)
    "separable": ("train_uncapped_4AA_separable", 32, 3, 500, []),
    "finetune": ("train_uncapped_4AA_separable", 32, 2, 100,
                 ["+finetune_on_init.num_steps=5", "+finetune_on_init.log_every=1"]),
    "uvw": ("train_uncapped_4AA", 4, 2, 50, []),
    "flax": ("flax_separable", 32, 1, 100, ["checkpoint_type=last"]),
}
SAMPLE_SAVE_EVERY = 5


def write_flax_checkpoint(src: str, dst: str) -> None:
    """The port's checkpoint `src` (Adam, no schedule) written again in
    flax's msgpack layout, as JAX's `save_checkpoint` writes its TrainState
    (`flax.serialization.to_bytes`): the map {step, params, opt_state:
    {"0": {count, mu, nu}, "1": {}}, ema_params, rng}, each array
    ExtType(1, msgpack (shape, dtype name, C-order bytes)). The key `rng` is
    zeros: the port carries none."""
    import msgpack

    from jamun_tpu_torch.params import to_jax_params

    data = torch.load(src, map_location="cpu", weights_only=True)
    names = list(data["params"])  # E3Conv holds no buffers: the parameters' order
    group = data["opt_state"]["param_groups"][0]
    slots = {n: data["opt_state"]["state"][i] for n, i in zip(names, group["params"])}

    def slot(key):
        return to_jax_params({n: st[key] for n, st in slots.items()})

    tree = {
        "step": np.asarray(data["step"], np.int32),
        "params": to_jax_params(data["params"]),
        "opt_state": {"0": {"count": np.asarray(group["count"], np.int32), "mu": slot("mu"),
                            "nu": slot("nu")}, "1": {}},
        "ema_params": to_jax_params(data["ema_params"]),
        "rng": np.zeros(2, np.uint32),
    }

    def ext(x):
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(1, msgpack.packb(
                (x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True))
        raise TypeError(type(x))

    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "wb") as f:
        f.write(msgpack.packb(tree, default=ext, strict_types=True))


@contextlib.contextmanager
def count_forwards(cls=None):
    """Counts the arch's (`E3Conv` unless `cls`) forward calls, with and
    without autograd recording ({"grad": n, "no_grad": n}): the denoiser
    calls of a CLI run. The counting wrapper keeps the forward's signature,
    which the Denoiser reads."""
    import functools

    from jamun_tpu_torch.models.e3conv import E3Conv

    cls = cls or E3Conv
    fwd, calls = cls.forward, {"grad": 0, "no_grad": 0}

    @functools.wraps(fwd)
    def counted(self, *args, **kwargs):
        calls["grad" if torch.is_grad_enabled() else "no_grad"] += 1
        return fwd(self, *args, **kwargs)

    cls.forward = counted
    try:
        yield calls
    finally:
        cls.forward = fwd


@contextlib.contextmanager
def time_metrics():
    """Host seconds inside the sample CLI's metrics callback (unbatched
    samples routed to the metrics, files written, and every metric's
    compute at the end): {"seconds": s}."""
    from jamun_tpu_torch.cmdline import sample as sample_cli

    cls, spent = sample_cli._AllMetricsCallback, {"seconds": 0.0}
    hooks = {name: getattr(cls, name) for name in ("on_after_sample_batch", "on_sample_end")}

    def timed(fn):
        def run(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                spent["seconds"] += time.perf_counter() - t0
        return run

    for name, fn in hooks.items():
        setattr(cls, name, timed(fn))
    try:
        yield spent
    finally:
        for name, fn in hooks.items():
            setattr(cls, name, fn)


def check_sampler_files(out_dir: str, labels, chains_per_label: int, batches: int, frames: int,
                        n_atoms: dict, far: bool = False) -> int:
    """JAX's sampler layout under `out_dir` (`cmdline/sample.py`), every
    `.npy` [frames, atoms, 3] and finite, and the joined trajectory read back
    through `load_run_trajectory` equal to the `.npy` batches concatenated
    in order (the DCD holds f32 Angstrom: 1e-6 nm; with `far`, for frames
    tens of nm out, as VESDE's first ones and a briefly trained Ophiuchus's,
    1e-6 of the largest coordinate).
    Returns the frames on disk."""
    from jamun_tpu_torch.analysis.load_trajectory import list_run_labels, load_run_trajectory

    run_dir = os.path.dirname(out_dir)
    assert os.path.basename(out_dir) == "sampler", out_dir
    assert list_run_labels(run_dir) == sorted(labels), list_run_labels(run_dir)
    assert os.path.exists(os.path.join(out_dir, "sampling_times.csv"))
    total = 0
    for label in labels:
        base = os.path.join(out_dir, label, "predicted_samples")
        stems = sorted({f.rsplit(".", 1)[0] for f in os.listdir(base) if f.startswith("batch_")},
                       key=lambda st: int(st.split("_")[1]))
        assert len(stems) == chains_per_label * batches, (label, len(stems))
        for st in stems:
            assert all(os.path.exists(os.path.join(base, f"{st}.{ext}")) for ext in ("dcd", "pdb")), st
        parts = [np.load(os.path.join(base, f"{st}.npy")) for st in stems]
        assert all(p.shape == (frames, n_atoms[label], 3) and np.isfinite(p).all() for p in parts)
        _, joined = load_run_trajectory(run_dir, label)
        assert joined.shape == (len(parts) * frames, n_atoms[label], 3), joined.shape
        both = np.concatenate(parts)
        err = float(np.abs(joined - both).max())
        assert err <= 1e-6 * (max(1.0, float(np.abs(both).max())) if far else 1.0), (label, err)
        assert os.path.exists(os.path.join(base, "topology.pdb"))
        assert os.path.exists(os.path.join(out_dir, label, "samples.html"))
        total += joined.shape[0]
    return total


def check_sample_launches(label: str, launches: dict, kabsch: int, calls: dict, ft_steps: int) -> None:
    """The kernels each phase 7 run must launch, and no other: the stack
    walk K3 once per denoiser call; the finetune K1 once and K2 six times
    per forward (its train steps' and its walks'), K4 six times and the
    Kabsch kernel once per train step; uvw none."""
    used = {k: v for k, v in launches.items() if v}
    if label in ("separable", "flax"):
        assert calls["grad"] == 0 and used == {"e3_stack": calls["no_grad"]}, (label, used, calls)
        assert kabsch == 0, (label, kabsch)
    elif label == "finetune":
        forwards = calls["grad"] + calls["no_grad"]
        assert calls["grad"] == ft_steps, calls
        assert used == {"edge_features": forwards, "conv_block": 6 * forwards,
                        "conv_block_bwd": 6 * ft_steps}, (label, used, calls)
        assert kabsch == ft_steps, kabsch
    else:
        assert not used and kabsch == 0, (label, used, kabsch)


def sample_cli_runs(dev, card: str, counters: dict, kabsch_kernel, work: str, atoms: dict) -> dict:
    """Phase 7: the sample CLI, `jamun_tpu_torch.cmdline.sample.main`, in
    process on phase 6's run directories, `experiment=sample_uncapped_4AA`
    with `init_datasets.root` at the 4AA validation split. `SAMPLE_RUNS`:
    the separable run on the stack path, the same finetuned on its starting
    frames first, the uvw run, and the separable checkpoint written again in
    flax's format (`write_flax_checkpoint`), whose score on a fixed batch
    must equal the torch file's bit for bit."""
    from jamun_tpu_torch.cmdline import sample as sample_cli
    from jamun_tpu_torch.train.checkpoints import checkpoint_format

    out, denoisers = {}, {}
    for label, (run_key, repeat, batches, steps, extra) in SAMPLE_RUNS.items():
        if label == "flax":  # the torch checkpoint the separable run restored, as JAX writes it
            src = out["separable"]["checkpoint"]
            dst = os.path.join("runs", run_key, "checkpoints", "last.ckpt")
            write_flax_checkpoint(src, dst)
            shutil.copy(os.path.join(os.path.dirname(os.path.dirname(src)), "config.pkl"),
                        os.path.join("runs", run_key, "config.pkl"))
            with open(dst, "rb") as f:
                assert checkpoint_format(f.read(4)) == "flax"
        args = ["--experiment-dir", EXP_DIR, "experiment=sample_uncapped_4AA",
                f"checkpoint_dir=runs/{run_key}/checkpoints", f"init_datasets.root={cli_val_dir(work)}",
                f"output_dir=runs/sample_{label}/sampler", f"repeat_init_samples={repeat}",
                f"num_batches={batches}", f"num_sampling_steps_per_batch={steps}",
                f"save_every_n_steps={SAMPLE_SAVE_EVERY}", *extra]
        for k in (*counters.values(), kabsch_kernel):
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with count_forwards() as calls, time_metrics() as metric_time:
            res = sample_cli.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {name: k.launches for name, k in counters.items()}
        kabsch = kabsch_kernel.launches
        ft_steps = 5 if label == "finetune" else 0
        check_sample_launches(label, launches, kabsch, calls, ft_steps)

        labels = sorted(CLI_VAL_SEQS)
        chains = repeat * len(labels)
        frames = 1 + (steps - 1) // SAMPLE_SAVE_EVERY
        on_disk = check_sampler_files(f"runs/sample_{label}/sampler", labels, repeat, batches, frames,
                                      atoms)
        assert on_disk == chains * batches * frames, on_disk
        # every denoiser call of the walks: the first score, steps - 1 updates, the final jump
        assert calls["no_grad"] == batches * (steps + 1), calls
        arch = res["denoiser"].arch
        assert arch.tensor_product == ("uvw" if label == "uvw" else "uvu")
        assert arch.fused_stack == (label != "finetune"), label  # JAX's rule; uvw takes no kernel
        for lbl in labels:
            r = res["results"][lbl]
            assert r["num_frames"] == repeat * batches * frames, r["num_frames"]
            assert math.isfinite(r["ramachandran_jsd"]) and math.isfinite(r["sliced_wasserstein"])
            assert 0.0 <= r["volume_exclusion_rate"] <= 1.0 and 0.0 <= r["bond_length_validity_rate"] <= 1.0
            assert all(math.isfinite(r[k]) for k in ("score_norm_mean", "score_norm_std", "score_norm_max"))
        # the CSV: one row per label; the warm rate leaves batch 0 out (the
        # kernels were built in phase 1, so batch 0 carries only the first
        # calls at these shapes, not nvcc), the other rate takes every batch
        rates = res["rates"]
        assert sorted(rates) == labels
        warm = rates[labels[0]]["time_per_sample_seconds"]
        with_build = rates[labels[0]]["time_per_sample_seconds_incl_compile"]
        walk_s = [b["batch_seconds"] for b in res["per_batch"]]
        warm_walk = walk_s[1:] if batches > 1 else walk_s
        per_batch_samples = chains * frames
        assert all(b["batch_samples"] == per_batch_samples for b in res["per_batch"])
        assert math.isclose(warm, sum(warm_walk) / (len(warm_walk) * per_batch_samples), rel_tol=1e-9)
        assert math.isclose(with_build, sum(walk_s) / (batches * per_batch_samples), rel_tol=1e-9)
        assert all(r["time_per_sample_seconds"] == warm for r in rates.values())
        row = dict(
            run_key=run_key, checkpoint=res["checkpoint"], chains=chains, batches=batches,
            steps=steps, frames_per_chain_batch=frames, frames_on_disk=on_disk,
            warm_ms_per_sample=warm * 1e3, ms_per_sample_with_build=with_build * 1e3,
            warm_ms_per_step=sum(warm_walk) * 1e3 / (len(warm_walk) * steps),
            batch_seconds=walk_s, metric_seconds=metric_time["seconds"], seconds=seconds,
            peak_bytes=peak, launches=launches, kabsch_launches=kabsch, forwards=dict(calls),
            finetune_losses=res["finetune_losses"],
            metrics={lbl: {k: v for k, v in res["results"][lbl].items() if isinstance(v, (int, float))}
                     for lbl in labels},
        )
        if label == "finetune":
            losses = res["finetune_losses"]
            assert len(losses) == ft_steps and all(math.isfinite(v) for v in losses), losses
            saved = torch.load(res["checkpoint"], map_location="cpu", weights_only=True)["ema_params"]
            moved = sum(not torch.equal(v.cpu(), saved[k]) for k, v in arch.state_dict().items())
            assert moved > len(saved) // 2, (moved, len(saved))
            row["ema_tensors_moved"] = moved
        denoisers[label] = res["denoiser"], res["state"]
        out[label] = row
        log(f"phase 7: sample CLI {label} ({run_key}, {os.path.basename(res['checkpoint'])}): "
            f"{chains} chains x {batches} batches x {steps} steps, {frames} frames per chain and "
            f"batch, {on_disk} frames on disk; warm {row['warm_ms_per_sample']:.6f} ms/sample "
            f"({row['warm_ms_per_step']:.3f} ms/step), with the build "
            f"{row['ms_per_sample_with_build']:.6f} ms/sample (batches "
            + " ".join(f"{t:.3f}" for t in walk_s) + " s); metrics on the host "
            f"{metric_time['seconds']:.3f} s; forwards {dict(calls)}; launches "
            f"{ {k: v for k, v in launches.items() if v} }, Kabsch {kabsch}; peak device memory "
            f"{peak / 2**30:.3f} GiB; {seconds:.1f} s in main on {card}"
            + (f"; finetune losses {' '.join(f'{v:.5f}' for v in res['finetune_losses'])}, "
               f"{row['ema_tensors_moved']} EMA tensors moved" if label == "finetune" else ""))

    # the flax file's model against the torch file's: the same EMA score on
    # a fixed batch, bit for bit, and the same train state
    batch = cli_score_batch(work).to_device(dev)
    with torch.no_grad():
        s_torch, s_flax = (denoisers[k][0].score(batch, SIGMA) for k in ("separable", "flax"))
    differ = bits_differ(s_flax, s_torch)
    assert torch.isfinite(s_torch).all() and differ == 0, differ
    st_torch, st_flax = denoisers["separable"][1], denoisers["flax"][1]
    assert st_flax.step == st_torch.step
    assert st_flax.optimizer.param_groups[0]["count"] == st_torch.optimizer.param_groups[0]["count"]
    for (name, p), q in zip(st_torch.module.named_parameters(), st_flax.module.parameters()):
        assert torch.equal(p, q), name
        for key in ("mu", "nu"):
            assert torch.equal(st_torch.optimizer.state[p][key], st_flax.optimizer.state[q][key]), (name, key)
    for (name, p), q in zip(st_torch.ema.named_parameters(), st_flax.ema.parameters()):
        assert torch.equal(p, q), name
    out["flax"]["score_bits_differ"] = differ
    log(f"phase 7: the flax-format checkpoint's EMA score on 3 fixed frames equals the torch "
        f"file's bit for bit ({s_torch.numel()} values), and so do its parameters, EMA, Adam's "
        f"mu, nu and count and the step; cut: {len(CLI_VAL_SEQS)} peptides x "
        f"repeat_init_samples chains instead of 1, {list(SAMPLE_RUNS)} at "
        + ", ".join(f"{b} x {n}" for _, _, b, n, _ in SAMPLE_RUNS.values())
        + " batches x steps instead of the config's 5 x 20000")
    return out


# phase 9: Ophiuchus (`model/arch=ophiuchus`) trained and sampled through the
# CLIs on phase 6's 4AA tree, VESDE (`batch_sampler=vesde`) on phase 6's
# separable run and on the Ophiuchus run, and UnrolledBAOAB on the stack
# path. Cut: 30 train steps instead of 10 epochs (as phase 6); sampling 4
# chains per peptide, 2 x 100 steps (BAOAB) and one batch of the config's
# N = 1000 steps (VESDE) instead of 5 x 20000
OPH_RUN_KEY = "train_uncapped_4AA_ophiuchus"
OPH_SAMPLE_RUNS = {
    # label: (train run key, repeat_init_samples, num_batches, steps per batch or None for
    # VESDE's N, extra overrides)
    "ophiuchus": (OPH_RUN_KEY, 4, 2, 100, []),
    "vesde_separable": ("train_uncapped_4AA_separable", 4, 1, None, ["batch_sampler=vesde"]),
    "vesde_ophiuchus": (OPH_RUN_KEY, 4, 1, None, ["batch_sampler=vesde"]),
}
VESDE_N = 1000  # the config's (`config/defaults/batch_sampler/vesde.yaml`)
UNROLLED_STEPS, UNROLLED_CHUNK = 101, 25


def oph_card_checks(run_dir: str, batch, dev) -> tuple:
    """The Ophiuchus run's trained weights (last.ckpt) in f32 on the card:
    its score against the CPU's on the same weights, relative to the max,
    and the arch's E(3) equivariance error on the card (a rotation and a
    shift of a fixed batch), relative to the output's max."""
    import pickle

    from jamun_tpu_torch.cmdline.common import build_denoiser
    from jamun_tpu_torch.utils.equivariance import equivariance_error

    score_err = cli_score_check(run_dir, batch, dev)
    with open(os.path.join(run_dir, "config.pkl"), "rb") as f:
        cfg = pickle.load(f)  # written by this run's CLI
    den = build_denoiser(cfg["model"], device=dev, seed=0)
    den.arch.load_state_dict(
        torch.load(os.path.join(run_dir, "checkpoints", "last.ckpt"), weights_only=True)["params"])
    den.arch.requires_grad_(False)
    c_noise = torch.tensor([math.log(SIGMA) / 4.0], device=dev)
    cutoff = den.effective_radial_cutoff(SIGMA)
    b = batch.to_device(dev)
    with torch.no_grad():
        scale = float(den.arch(b, c_noise, cutoff).abs().max())
    err = equivariance_error(lambda x: den.arch(x, c_noise, cutoff), b) / scale
    return score_err, err


def check_no_launches(label: str, launches: dict, kabsch: int, want_kabsch: bool) -> None:
    """No kernel of K1-K9 ran; the Kabsch kernel ran (aligned training) or
    not (sampling)."""
    used = {k: v for k, v in launches.items() if v}
    assert not used, (label, used)
    assert (kabsch > 0) == want_kabsch, (label, kabsch)


def ophiuchus_train_run(dev, card: str, counters: dict, kabsch_kernel, work: str, atoms: dict) -> dict:
    """Phase 9a: `experiment=train_uncapped_4AA model/arch=ophiuchus` through
    the train CLI at the config's full width (64x0e + 64x1e, 4 layers,
    mul_factor 64, edge_attr_dim 8, uvw, f32, batch 32): `CLI_STEPS` steps,
    validating every `CLI_VAL_EVERY`. No kernel of K1-K9; the Kabsch kernel
    aligns every batch."""
    import statistics

    from jamun_tpu_torch.cmdline import train as train_cli
    from jamun_tpu_torch.models.ophiuchus import Ophiuchus

    args = ["--experiment-dir", EXP_DIR, "experiment=train_uncapped_4AA", "model/arch=ophiuchus",
            f"run_key={OPH_RUN_KEY}", f"trainer.max_steps={CLI_STEPS}",
            f"trainer.val_every_n_steps={CLI_VAL_EVERY}", "trainer.log_every_n_steps=1"]
    for k in (*counters.values(), kabsch_kernel):
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with count_forwards(Ophiuchus) as calls:
        state = train_cli.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: k.launches for name, k in counters.items()}
    kabsch = kabsch_kernel.launches
    check_no_launches("ophiuchus train", launches, kabsch, want_kabsch=True)
    run_dir = os.path.join("runs", OPH_RUN_KEY)
    train, val = read_metrics_csv(os.path.join(run_dir, "metrics.csv"))
    losses = [r["train/loss"] for r in train]
    arch = state.module
    assert isinstance(arch, Ophiuchus) and arch.tensor_product == "uvw" and arch.dtype is None
    assert (str(arch.irreps_hidden), arch.n_layers, arch.edge_attr_dim) == ("64x0e + 64x1e", 4, 8)
    assert state.step == CLI_STEPS and [r["step"] for r in train] == list(range(1, CLI_STEPS + 1))
    assert [r["step"] for r in val] == [CLI_VAL_EVERY, CLI_STEPS], val
    assert all(math.isfinite(v) for v in losses + [r["val/loss"] for r in val])
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    assert calls["grad"] == CLI_STEPS, calls
    ms_step = statistics.median((b["time"] - a["time"]) * 1e3 for a, b in zip(train, train[1:]))
    score_err, equi_err = oph_card_checks(run_dir, cli_score_batch(work), dev)
    assert score_err < 1e-3, score_err
    assert equi_err < 1e-3, equi_err
    out = dict(run_key=OPH_RUN_KEY, steps=CLI_STEPS, seconds=seconds, ms_per_step=ms_step,
               peak_bytes=peak, first_loss=losses[0], last_loss=losses[-1],
               val_loss=[r["val/loss"] for r in val], batch=32, launches=launches,
               kabsch_launches=kabsch, forwards=dict(calls), score_rel_err=score_err,
               equivariance_rel_err=equi_err,
               parameters=sum(p.numel() for p in arch.parameters()))
    log(f"phase 9a: Ophiuchus ({OPH_RUN_KEY}, uvw, 64x0e + 64x1e, 4 layers, f32, batch 32): "
        f"{ms_step:.3f} ms/step (median gap of metrics.csv's rows), peak device memory "
        f"{peak / 2**30:.3f} GiB, {out['parameters']} parameters, train loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}, val loss " + " ".join(f"{r['val/loss']:.5f}" for r in val)
        + f"; forwards {dict(calls)}; K1-K9 launches 0, Kabsch {kabsch}; f32 score card vs CPU "
        f"rel err {score_err:.3g} (tol 1e-3), E(3) error on the card {equi_err:.3g} of the "
        f"output's max (tol 1e-3); {seconds:.1f} s in main on {card}")
    return out


@contextlib.contextmanager
def record_vesde():
    """The shape of each output of every VESDE anneal and whether its sample
    is finite: a list of dicts."""
    from jamun_tpu_torch.sampling.vesde import VESDEReverseDiffusionSampler

    anneal, seen = VESDEReverseDiffusionSampler.anneal, []

    def recorded(self, *args, **kwargs):
        out = anneal(self, *args, **kwargs)
        row = {k: tuple(v.shape) for k, v in out.items()}
        row["finite"] = bool(torch.isfinite(out["sample"]).all())
        seen.append(row)
        return out

    VESDEReverseDiffusionSampler.anneal = recorded
    try:
        yield seen
    finally:
        VESDEReverseDiffusionSampler.anneal = anneal


def ophiuchus_vesde_sample_runs(dev, card: str, counters: dict, kabsch_kernel, work: str,
                                atoms: dict) -> dict:
    """Phases 9b and 9c: `experiment=sample_uncapped_4AA` through the sample
    CLI (`OPH_SAMPLE_RUNS`): the Ophiuchus run with BAOAB (no kernel), and
    `batch_sampler=vesde` on phase 6's separable run (K3 once per denoiser
    call, N per batch, nothing else) and on the Ophiuchus run (no kernel).
    VESDE's trajectories are JAX's [N, G, N_atoms, 3]. After the Ophiuchus
    run, `profile_walk` of its sampling model on three fixed frames."""
    from jamun_tpu_torch.cmdline import sample as sample_cli
    from jamun_tpu_torch.models.e3conv import E3Conv
    from jamun_tpu_torch.models.ophiuchus import Ophiuchus

    out = {}
    labels = sorted(CLI_VAL_SEQS)
    for label, (run_key, repeat, batches, steps, extra) in OPH_SAMPLE_RUNS.items():
        vesde = steps is None
        args = ["--experiment-dir", EXP_DIR, "experiment=sample_uncapped_4AA",
                f"checkpoint_dir=runs/{run_key}/checkpoints", f"init_datasets.root={cli_val_dir(work)}",
                f"output_dir=runs/sample_{label}/sampler", f"repeat_init_samples={repeat}",
                f"num_batches={batches}", f"save_every_n_steps={SAMPLE_SAVE_EVERY}", *extra]
        if not vesde:
            args.append(f"num_sampling_steps_per_batch={steps}")
        cls = Ophiuchus if run_key == OPH_RUN_KEY else E3Conv
        for k in (*counters.values(), kabsch_kernel):
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with count_forwards(cls) as calls, time_metrics() as metric_time, record_vesde() as anneals:
            res = sample_cli.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {name: k.launches for name, k in counters.items()}
        kabsch = kabsch_kernel.launches
        assert isinstance(res["denoiser"].arch, cls), label
        chains = repeat * len(labels)
        if vesde:
            frames, n_steps = VESDE_N, VESDE_N
            G, N = chains, 48
            assert calls == {"grad": 0, "no_grad": batches * VESDE_N}, (label, calls)
            assert len(anneals) == batches and all(a["finite"] for a in anneals), anneals
            for a in anneals:
                for k in ("y_traj", "y_mean_traj", "xhat_traj"):
                    assert a[k] == (VESDE_N, G, N, 3), (label, k, a[k])
                assert a["sample"] == a["y"] == a["v"] == (G, N, 3), a
        else:
            frames, n_steps = 1 + (steps - 1) // SAMPLE_SAVE_EVERY, steps
            assert calls == {"grad": 0, "no_grad": batches * (steps + 1)}, (label, calls)
            assert not anneals
        if cls is E3Conv:
            assert res["denoiser"].arch.fused_stack
            want = dict.fromkeys(launches, 0)
            want["e3_stack"] = calls["no_grad"]
            assert launches == want and kabsch == 0, (label, launches, kabsch)
        else:
            check_no_launches(label, launches, kabsch, want_kabsch=False)
        on_disk = check_sampler_files(f"runs/sample_{label}/sampler", labels, repeat, batches, frames,
                                      atoms, far=True)
        assert on_disk == chains * batches * frames, on_disk
        for lbl in labels:
            r = res["results"][lbl]
            assert r["num_frames"] == repeat * batches * frames, r["num_frames"]
            assert math.isfinite(r["ramachandran_jsd"])
        walk_s = [b["batch_seconds"] for b in res["per_batch"]]
        warm = walk_s[1:] if batches > 1 else walk_s
        row = dict(run_key=run_key, checkpoint=res["checkpoint"], chains=chains, batches=batches,
                   steps=n_steps, frames_per_chain_batch=frames, frames_on_disk=on_disk,
                   warm_ms_per_step=sum(warm) * 1e3 / (len(warm) * n_steps), batch_seconds=walk_s,
                   metric_seconds=metric_time["seconds"], seconds=seconds, peak_bytes=peak,
                   launches=launches, kabsch_launches=kabsch, forwards=dict(calls),
                   anneal_shapes=anneals)
        if label == "ophiuchus":  # the device's share of a short walk of the sampling model
            row["profile"] = profile_walk(res["denoiser"], cli_score_batch(work).to_device(dev), dev, 6,
                                          "Ophiuchus 4AA G=3")
        out[label] = row
        log(f"phase 9{'c' if vesde else 'b'}: sample CLI {label} ({run_key}, "
            f"{'VESDE N = %d' % VESDE_N if vesde else 'BAOAB'}): {chains} chains x {batches} "
            f"batches x {n_steps} steps, {frames} frames per chain and batch, {on_disk} on disk; "
            f"warm {row['warm_ms_per_step']:.3f} ms/step (batches "
            + " ".join(f"{t:.3f}" for t in walk_s) + " s); metrics on the host "
            f"{metric_time['seconds']:.3f} s; forwards {dict(calls)}; launches "
            f"{ {k: v for k, v in launches.items() if v} }, Kabsch {kabsch}; peak device memory "
            f"{peak / 2**30:.3f} GiB; {seconds:.1f} s in main on {card}"
            + (f"; trajectories {anneals[0]['xhat_traj']}" if vesde else ""))
    return out


def unrolled_walk(den_stack, dev, card: str, counters: dict) -> dict:
    """Phase 9d: `UnrolledBAOAB` on the separable flagship's stack path (K3)
    at 4AA, G = 256, `UNROLLED_STEPS` steps in chunks of `UNROLLED_CHUNK`:
    K3 once per update and once per chunk (its first score), nothing else.
    Then `BAOAB` from the same start on the same generator seed (not
    counted): the frames compared bit for bit."""
    from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
    from jamun_tpu_torch.sampling.unrolled import UnrolledBAOAB
    from jamun_tpu_torch.utils.testing import make_test_batch

    G, N = 256, 44
    batch = make_test_batch(num_graphs=G, max_nodes=N, nodes_per_graph=[N] * G, max_bonds=2 * N,
                            scale=0.35, device=dev)
    cfg = MCMCConfig(delta=0.04, friction=1.0, M=1.0, steps=UNROLLED_STEPS, save_every_n_steps=1,
                     score_fn_clip=100.0)
    mask = batch.node_mask[..., None].float()
    y0 = batch.pos + SIGMA * torch.randn(
        batch.pos.shape, generator=torch.Generator(device=dev).manual_seed(2), device=dev) * mask

    def score(y):
        return den_stack.score(batch.replace_pos(y), SIGMA)

    def walk(mcmc):
        gen = torch.Generator(device=dev).manual_seed(3)
        with torch.no_grad():
            return mcmc(y0, score, gen, "gaussian", mask)

    updates = (UNROLLED_STEPS - 1) // UNROLLED_CHUNK * UNROLLED_CHUNK
    for k in counters.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, v, traj, scores = walk(UnrolledBAOAB(cfg, chunk_steps=UNROLLED_CHUNK))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    want = dict.fromkeys(launches, 0)
    want["e3_stack"] = updates + updates // UNROLLED_CHUNK
    assert launches == want, (launches, want)
    assert traj.shape == (1 + updates, G, N, 3) and torch.isfinite(traj).all()
    assert not scores.any()
    _, _, ref, _ = walk(BAOAB(dataclasses.replace(cfg, steps=updates + 1)))
    differ = bits_differ(traj, ref)
    max_diff = float((traj - ref).abs().max())
    out = dict(G=G, N=N, steps=UNROLLED_STEPS, chunk_steps=UNROLLED_CHUNK, seconds=dt,
               ms_per_step=dt * 1e3 / updates, launches=launches, frames=traj.shape[0],
               bits_differ_from_baoab=differ, max_abs_diff_from_baoab=max_diff)
    log(f"phase 9d: UnrolledBAOAB on the stack path, 4AA N={N} G={G}, {UNROLLED_STEPS} steps in "
        f"chunks of {UNROLLED_CHUNK}: {dt:.3f} s, {out['ms_per_step']:.3f} ms/step; launches "
        f"{ {k: v for k, v in launches.items() if v} } ({updates} updates + "
        f"{updates // UNROLLED_CHUNK} chunk starts); frames against BAOAB on the same generator: "
        f"{differ} of {traj.numel()} values differ in their bits, largest difference "
        f"{max_diff:.3g} nm; on {card}")
    return out


# phase 10: the rest of the equivariant-ops library on the card, in phase
# 6's work directory: the experimental product at the flagship width
# through the train and sample CLIs, the l = 2 separable model through the
# train CLI and a BAOAB walk of its EMA model, and attention and EquiFold
# forward and backward on the 4AA training batch. None of these reaches a
# TPU kernel in JAX, and none launches K1-K9 here. Cut: 20 train steps,
# validating once, instead of 10 epochs; sampling 4 chains per peptide,
# 2 x 100 steps (experimental) and 1 x 50 (l = 2) instead of 5 x 20000
P10_STEPS = 20
L2_SH, L2_HIDDEN = "1x0e + 1x1e + 1x2e", "120x0e + 32x1e + 16x2e"
P10_TRAIN_RUNS = {
    # label: (run key, overrides, (tensor_product, irreps_hidden, irreps_sh, dtype))
    "experimental": ("train_uncapped_4AA_experimental", ["model.arch.tensor_product=experimental"],
                     ("experimental", "120x0e + 32x1e", "1x0e + 1x1e", None)),
    "l2": ("train_uncapped_4AA_separable_l2",
           ["model/arch=e3conv_separable", f"model.arch.irreps_sh={L2_SH}",
            f"model.arch.irreps_hidden={L2_HIDDEN}"],
           ("uvu", L2_HIDDEN, L2_SH, torch.bfloat16)),
}
# label: (train run label, repeat_init_samples, num_batches, steps per batch)
P10_SAMPLE_RUNS = {"experimental": ("experimental", 4, 2, 100), "l2_walk": ("l2", 4, 1, 50)}
P10_HEADS, P10_NC = 4, 32  # attention heads; EquiFold's channels (nc_s = nc_v)
P10_COMPARE_GRAPHS = 4  # graphs of the training batch held against the CPU in 10c


def p10_card_checks(run_dir: str, batch, dev) -> dict:
    """A phase 10 run's trained weights (last.ckpt) in f32: the score on the
    card against the CPU's (`cli_score_check`), and on the card the E(3)
    error of the output (`1x1e`) and of the last hidden layer's features
    (the hidden irreps, rotated by the port's Wigner D, `ops/wigner.py`),
    each relative to its max."""
    import pickle

    from jamun_tpu_torch.cmdline.common import build_denoiser
    from jamun_tpu_torch.utils.equivariance import equivariance_error

    score_err = cli_score_check(run_dir, batch, dev)
    with open(os.path.join(run_dir, "config.pkl"), "rb") as f:
        cfg = pickle.load(f)  # written by this run's CLI
    model_cfg = dict(cfg["model"], arch=dict(cfg["model"]["arch"], dtype=None))
    den = build_denoiser(model_cfg, device=dev, seed=0)
    arch = den.arch
    arch.load_state_dict(
        torch.load(os.path.join(run_dir, "checkpoints", "last.ckpt"), weights_only=True)["params"])
    arch.requires_grad_(False)
    assert not arch.kernels, "phase 10's archs take no kernel"
    c_noise = torch.tensor([math.log(SIGMA) / 4.0], device=dev)
    cutoff = den.effective_radial_cutoff(SIGMA)
    b = batch.to_device(dev)
    last = getattr(arch, f"_HiddenLayer_{arch.n_layers - 1}")
    seen = {}
    hook = last.register_forward_hook(lambda m, args, out: seen.__setitem__("h", out))

    def hidden(x):
        arch(x, c_noise, cutoff)
        return seen["h"] * x.node_mask[..., None]

    try:
        with torch.no_grad():
            out_scale = float(arch(b, c_noise, cutoff).abs().max())
            hid_scale = float(hidden(b).abs().max())
        out_err = equivariance_error(lambda x: arch(x, c_noise, cutoff), b) / out_scale
        hid_err = equivariance_error(hidden, b, irreps_out=arch.irreps_hidden) / hid_scale
    finally:
        hook.remove()
    return dict(score_rel_err=score_err, equivariance_rel_err=out_err,
                hidden_equivariance_rel_err=hid_err, hidden_irreps=str(arch.irreps_hidden))


def p10_train_runs(dev, card: str, counters: dict, kabsch_kernel, work: str) -> dict:
    """Phases 10a and 10b, training: `P10_TRAIN_RUNS` through the train CLI
    at the config's full width, `P10_STEPS` steps validating once; finite,
    falling losses, K1-K9 never, the Kabsch kernel on every batch; ms/step,
    peak memory; the card checks of `p10_card_checks` (1e-3)."""
    import statistics

    from jamun_tpu_torch.cmdline import train as train_cli

    out = {}
    for label, (run_key, extra, (tp, hidden, sh, dtype)) in P10_TRAIN_RUNS.items():
        args = ["--experiment-dir", EXP_DIR, "experiment=train_uncapped_4AA", f"run_key={run_key}",
                *extra, f"trainer.max_steps={P10_STEPS}", f"trainer.val_every_n_steps={P10_STEPS}",
                "trainer.log_every_n_steps=1"]
        for k in (*counters.values(), kabsch_kernel):
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with count_forwards() as calls:
            state = train_cli.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {name: k.launches for name, k in counters.items()}
        kabsch = kabsch_kernel.launches
        check_no_launches(f"phase 10 train {label}", launches, kabsch, want_kabsch=True)
        arch = state.module
        assert (arch.tensor_product, str(arch.irreps_hidden), str(arch.irreps_sh), arch.dtype) == (
            tp, hidden, sh, dtype), (arch.tensor_product, arch.irreps_hidden, arch.irreps_sh, arch.dtype)
        assert not arch.kernels and arch.n_layers == 5 and arch.edge_attr_dim == 64
        run_dir = os.path.join("runs", run_key)
        train, val = read_metrics_csv(os.path.join(run_dir, "metrics.csv"))
        losses = [r["train/loss"] for r in train]
        assert state.step == P10_STEPS and [r["step"] for r in train] == list(range(1, P10_STEPS + 1))
        assert [r["step"] for r in val] == [P10_STEPS], val
        assert all(math.isfinite(v) for v in losses + [r["val/loss"] for r in val])
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        assert last < first, (label, first, last)
        assert calls["grad"] == P10_STEPS, calls
        ms_step = statistics.median((b["time"] - a["time"]) * 1e3 for a, b in zip(train, train[1:]))
        checks = p10_card_checks(run_dir, cli_score_batch(work), dev)
        for key in ("score_rel_err", "equivariance_rel_err", "hidden_equivariance_rel_err"):
            assert checks[key] < 1e-3, (label, key, checks[key])
        out[label] = dict(run_key=run_key, steps=P10_STEPS, seconds=seconds, ms_per_step=ms_step,
                          peak_bytes=peak, losses=losses, val_loss=[r["val/loss"] for r in val],
                          batch=32, launches=launches, kabsch_launches=kabsch, forwards=dict(calls),
                          parameters=sum(p.numel() for p in arch.parameters()), **checks)
        log(f"phase 10{'a' if label == 'experimental' else 'b'}: train {label} ({run_key}: {tp}, "
            f"hidden {hidden}, SH {sh}, {'bf16' if dtype else 'f32'}, batch 32): {ms_step:.3f} ms/step "
            f"(median gap of metrics.csv's rows), peak device memory {peak / 2**30:.3f} GiB, "
            f"{out[label]['parameters']} parameters; losses " + " ".join(f"{v:.5f}" for v in losses)
            + f" (mean of steps 1-5 {first:.5f}, 16-20 {last:.5f}); val loss {val[0]['val/loss']:.5f}; "
            f"forwards {dict(calls)}; K1-K9 launches 0, Kabsch {kabsch}; f32 score card vs CPU rel "
            f"err {checks['score_rel_err']:.3g} (tol 1e-3); E(3) error on the card, output "
            f"{checks['equivariance_rel_err']:.3g}, hidden features ({checks['hidden_irreps']}) "
            f"{checks['hidden_equivariance_rel_err']:.3g} of their max (tol 1e-3); {seconds:.1f} s in "
            f"main on {card}")
    return out


def p10_sample_runs(dev, card: str, counters: dict, kabsch_kernel, work: str, atoms: dict) -> dict:
    """Phase 10a's sampling and 10b's walk: `experiment=sample_uncapped_4AA`
    through the sample CLI on the phase 10 runs (`P10_SAMPLE_RUNS`), BAOAB
    with the EMA weights: no kernel at all, JAX's sampler layout on disk,
    finite samples and metrics; warm ms/step and peak memory; then a
    profiled 6-step walk of the sampling model (device busy share, device
    ops per forward)."""
    from jamun_tpu_torch.cmdline import sample as sample_cli

    out = {}
    labels = sorted(CLI_VAL_SEQS)
    for label, (train_label, repeat, batches, steps) in P10_SAMPLE_RUNS.items():
        run_key = P10_TRAIN_RUNS[train_label][0]
        args = ["--experiment-dir", EXP_DIR, "experiment=sample_uncapped_4AA",
                f"checkpoint_dir=runs/{run_key}/checkpoints", f"init_datasets.root={cli_val_dir(work)}",
                f"output_dir=runs/sample_{label}/sampler", f"repeat_init_samples={repeat}",
                f"num_batches={batches}", f"num_sampling_steps_per_batch={steps}",
                f"save_every_n_steps={SAMPLE_SAVE_EVERY}"]
        for k in (*counters.values(), kabsch_kernel):
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with count_forwards() as calls, time_metrics() as metric_time:
            res = sample_cli.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {name: k.launches for name, k in counters.items()}
        check_no_launches(f"phase 10 sample {label}", launches, kabsch_kernel.launches, want_kabsch=False)
        assert not res["denoiser"].arch.kernels
        assert calls == {"grad": 0, "no_grad": batches * (steps + 1)}, (label, calls)
        frames = 1 + (steps - 1) // SAMPLE_SAVE_EVERY
        on_disk = check_sampler_files(f"runs/sample_{label}/sampler", labels, repeat, batches, frames,
                                      atoms, far=True)
        chains = repeat * len(labels)
        assert on_disk == chains * batches * frames, on_disk
        for lbl in labels:
            assert res["results"][lbl]["num_frames"] == repeat * batches * frames
            assert math.isfinite(res["results"][lbl]["ramachandran_jsd"])
        walk_s = [b["batch_seconds"] for b in res["per_batch"]]
        warm = walk_s[1:] if batches > 1 else walk_s
        out[label] = dict(run_key=run_key, chains=chains, batches=batches, steps=steps,
                          frames_on_disk=on_disk, warm_ms_per_step=sum(warm) * 1e3 / (len(warm) * steps),
                          batch_seconds=walk_s, metric_seconds=metric_time["seconds"], seconds=seconds,
                          peak_bytes=peak, launches=launches, forwards=dict(calls))
        # the device's share of a short walk of the sampling model
        out[label]["profile"] = profile_walk(res["denoiser"], cli_score_batch(work).to_device(dev), dev, 6,
                                             f"phase 10 {label} 4AA G=3")
        log(f"phase 10{'a' if label == 'experimental' else 'b'}: sample CLI {label} ({run_key}, BAOAB, "
            f"EMA weights): {chains} chains x {batches} batches x {steps} steps, {on_disk} frames on "
            f"disk; {'warm ' if batches > 1 else ''}{out[label]['warm_ms_per_step']:.3f} ms/step "
            "(batches " + " ".join(f"{t:.3f}" for t in walk_s) + " s); metrics on the host "
            f"{metric_time['seconds']:.3f} s; forwards {dict(calls)}; no kernel launched; peak device "
            f"memory {peak / 2**30:.3f} GiB; {seconds:.1f} s in main on {card}")
    return out


def p10_training_batch(work: str, dev):
    """Phase 6's 4AA training batch: 32 frames (8 of each training
    peptide), the 48-atom bucket, on the card."""
    from jamun_tpu_torch.data.batching import collate
    from jamun_tpu_torch.data.discovery import parse_datasets_from_directory

    train_sets = parse_datasets_from_directory(
        os.path.join(work, "data", "timewarp", "4AA-large", "train"), "^(.*)-traj-arrays.npz",
        "^(.*)-traj-state0.pdb")
    batch = collate([ds[25 * k] for ds in train_sets for k in range(8)])
    assert tuple(batch.pos.shape) == (32, 48, 3), tuple(batch.pos.shape)
    return batch.to_device(dev)


def p10_modules(dev, batch, cutoff: float):
    """Phase 10c's three modules at their phase widths, parameters drawn
    from seed 0 (`params.init_parameters`), and for each a function of (the
    module, a batch, its features) that builds the module's inputs from the
    batch's positions and returns its outputs, the random inputs (seeded),
    and how they rotate: ("name", module, fn, inputs, rotate(inputs, R, D))."""
    import functools

    from jamun_tpu_torch.ops.attention import TransformerBlock
    from jamun_tpu_torch.ops.contrib.equifold import Convnet, Equiformer, RadialNN
    from jamun_tpu_torch.ops.graph import dense_edge_data
    from jamun_tpu_torch.ops.irreps import Irreps
    from jamun_tpu_torch.ops.radial import soft_one_hot_linspace
    from jamun_tpu_torch.ops.sh import SH_IRREPS, spherical_harmonics
    from jamun_tpu_torch.params import init_parameters

    irreps = Irreps("120x0e + 32x1e")
    G, N = batch.pos.shape[:2]
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((G, N, irreps.dim), generator=gen).to(dev) * batch.node_mask[..., None]
    s = torch.randn((G, N, P10_NC), generator=gen).to(dev)
    v = torch.randn((G, N, P10_NC, 3), generator=gen).to(dev)

    def attr(d, bonded):  # 64 edge attributes: the radial basis, bonds shifted by one
        return soft_one_hot_linspace(d, 0.0, cutoff, 64) + (1.0 if bonded else 0.0)

    def attention(m, b, feats):
        edges = dense_edge_data(b.pos, b.node_mask, b.bond_src, b.bond_dst, b.bond_mask, cutoff,
                                functools.partial(spherical_harmonics, SH_IRREPS), attr)
        return (m(feats[0], edges),)

    def pairs(m, b, feats):
        d = b.pos[:, :, None, :] - b.pos[:, None, :, :]  # i (dst) - j (src)
        r = torch.sqrt((d * d).sum(-1) + 1e-12)
        eye = torch.eye(N, dtype=torch.bool, device=b.pos.device)
        mask = b.node_mask[:, :, None] & b.node_mask[:, None, :] & ~eye & (r < cutoff)
        envelope = 0.5 * (torch.cos(math.pi * r / cutoff) + 1.0) * (r < cutoff)
        return m(feats[0], feats[1], mask, r, d / r[..., None], envelope)

    radial = functools.partial(RadialNN, rc=cutoff)
    out = [
        ("TransformerBlock", TransformerBlock(irreps, irreps, SH_IRREPS, 64, n_head=P10_HEADS), attention,
         (x,), lambda f, R, D: (f[0] @ D.T,)),
        ("Equiformer", Equiformer(P10_NC, P10_NC, radial, num_heads=P10_HEADS), pairs, (s, v),
         lambda f, R, D: (f[0], f[1] @ R.T)),
        ("Convnet", Convnet(P10_NC, P10_NC, radial), pairs, (s, v),
         lambda f, R, D: (f[0], f[1] @ R.T)),
    ]
    return [(name, init_parameters(m, 0).to(dev), fn, feats, rot) for name, m, fn, feats, rot in out]


def p10_attention_equifold(dev, card: str, counters: dict, work: str) -> dict:
    """Phase 10c: `TransformerBlock` (120x0e + 32x1e, SH 1x0e + 1x1e, 64
    edge attributes, 4 heads), `Equiformer` (32 channels, 4 heads) and
    `Convnet` (32 channels) on phase 6's 4AA training batch (G = 32, N = 48,
    its dense pairs within 1 nm), f32, forward and backward (a projection's
    gradient in every parameter and input feature): ms per forward +
    backward (CUDA events over 3 after one warm-up) and peak memory; the
    card against the CPU on the batch's first `P10_COMPARE_GRAPHS` graphs
    (outputs and gradients, 1e-3 of each one's max); the E(3) error on the
    card at G = 32 (1e-3 of the output's max); K1-K9 never."""
    import copy

    from jamun_tpu_torch.ops.irreps import Irreps
    from jamun_tpu_torch.ops.wigner import random_rotation

    cutoff = 1.0
    batch = p10_training_batch(work, dev)
    for k in counters.values():
        k.launches = 0
    out = {}
    for name, module, fn, feats, rotate in p10_modules(dev, batch, cutoff):
        proj = [torch.randn(o.shape, generator=torch.Generator().manual_seed(6)).to(dev)
                for o in fn(module, batch, feats)]

        def fwd_bwd(m, b, inputs, p):
            m.zero_grad()
            inputs = [t.detach().clone().requires_grad_() for t in inputs]
            outs = fn(m, b, inputs)
            sum((o * q).sum() for o, q in zip(outs, p)).backward()
            return [o.detach() for o in outs], {n: w.grad for n, w in m.named_parameters()}, [
                t.grad for t in inputs]

        fwd_bwd(module, batch, feats, proj)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            fwd_bwd(module, batch, feats, proj)
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / 3
        peak = torch.cuda.max_memory_allocated()

        # the card against the CPU on the first graphs
        sub = batch.map(lambda t: t[:P10_COMPARE_GRAPHS])
        sub_feats = [t[:P10_COMPARE_GRAPHS] for t in feats]
        sub_proj = [q[:P10_COMPARE_GRAPHS] for q in proj]
        got = fwd_bwd(module, sub, sub_feats, sub_proj)
        cpu = copy.deepcopy(module).to("cpu")
        want = fwd_bwd(cpu, sub.to("cpu"), [t.cpu() for t in sub_feats], [q.cpu() for q in sub_proj])
        errs = {}
        for key, g, w in (("output", got[0], want[0]), ("input grad", got[2], want[2])):
            errs[key] = max(rel_err(a.cpu(), b)[1] for a, b in zip(g, w))
        errs["parameter grad"] = max(rel_err(got[1][n].cpu(), want[1][n])[1] for n in want[1])
        for key, e in errs.items():
            assert e < 1e-3, (name, key, e)

        # E(3) on the card at the full batch
        R = random_rotation(np.random.default_rng(7)).astype(np.float32)
        D = torch.from_numpy(Irreps("120x0e + 32x1e").rotation_matrix(R).astype(np.float32)).to(dev)
        Rt = torch.from_numpy(R).to(dev)
        with torch.no_grad():
            outs = fn(module, batch, feats)
            rot_batch = batch.replace_pos(batch.pos @ Rt.T + 0.3)
            outs_rot = fn(module, rot_batch, rotate(feats, Rt, D))
            want_rot = rotate(outs, Rt, D)
        mask = batch.node_mask[..., None]
        equi = max(float(((a - b).flatten(2) * mask).abs().max()) / float(b.abs().max())
                   for a, b in zip(outs_rot, want_rot))
        assert equi < 1e-3, (name, equi)
        assert all(torch.isfinite(o).all() for o in outs)
        out[name] = dict(ms_fwd_bwd=ms, peak_bytes=peak, card_vs_cpu=errs, equivariance_rel_err=equi,
                         parameters=sum(p.numel() for p in module.parameters()))
        log(f"phase 10c: {name} on the 4AA training batch (G = 32, N = 48, f32): {ms:.3f} ms per "
            f"forward + backward (CUDA events, 3 after a warm-up), peak device memory "
            f"{peak / 2**30:.3f} GiB, {out[name]['parameters']} parameters; card vs CPU on "
            f"{P10_COMPARE_GRAPHS} graphs: output {errs['output']:.3g}, parameter gradients "
            f"{errs['parameter grad']:.3g}, input gradients {errs['input grad']:.3g} (tol 1e-3); E(3) "
            f"error on the card {equi:.3g} of the output's max (tol 1e-3); on {card}")
        del module
        torch.cuda.empty_cache()
    launches = {n: k.launches for n, k in counters.items()}
    assert not any(launches.values()), launches
    out["launches"] = launches
    return out


# phase 8: the IDRome regime through the CLIs: an IDRome-layout tree of two
# disordered-region chains (`build_peptide`, hydrogens in `top.pdb`, every
# atom in `traj.xtc`) of about 600 and 1100 heavy atoms (buckets 1024 and
# 2048), and their CA beads as the coarse-grained layout in `.dcd`
IDR_CHAINS = {"idr_0600": (600, 1), "idr_1100": (1100, 2)}  # name: (heavy atoms, sequence seed)
IDR_FRAMES = 200
IDR_STEPS = 6  # train steps of each run, validation once at the last
# validation batches: with `streaming: true` the DataModule streams the
# validation sets too (as JAX's does), up to `val_max_batches` (1000 in
# train_idrome)
IDR_VAL_BATCHES = 4
IDR_TRAIN_RUNS = {
    # label: (experiment, run key, extra overrides, batch size)
    "separable": ("train_idrome", "train_idrome_separable",
                  ["model/arch=e3conv_separable", "run_key=train_idrome_separable"], 32),
    # the config's uvw at batch 32 needs about 45 GB a graph at N = 2048:
    # one graph a batch (the cut, listed in the log)
    "uvw": ("train_idrome", "train_idrome", [], 1),
    # a group override drops the experiment's arch keys (JAX's composition
    # too), so the atom-only embedding is asked for again
    "cg": ("train_idrome_cg", "train_idrome_cg",
           ["model/arch=e3conv_separable", "model.arch.use_residue_information=false"], 8),
}
IDR_SAMPLE_STEPS, IDR_SAMPLE_BATCHES = 200, 2
IDROME_DIR = ("IDRome_v4_preprocessed", "all_atom_relaxed_combined")


def write_idrome_data(root: str, seed: int = 0) -> dict:
    """The IDRome tree under `root` (`utils.testing.write_idrome_tree`,
    the port's `write_xtc`) and the coarse-grained tree
    `idrome_cg/{train,val}/<name>.{pdb,dcd}`: the 600-atom chain's beads and
    the 1100-atom chain's first 120 residues to train, its last 90 to
    validate (every bead count at most 128: the dense kernels' range).
    Returns the heavy-atom and bead counts."""
    from jamun_tpu_torch.utils.testing import idr_sequence, write_cg_tree, write_idrome_tree

    seqs = {name: idr_sequence(n, s) for name, (n, s) in IDR_CHAINS.items()}
    heavy = write_idrome_tree(os.path.join(root, *IDROME_DIR), seqs, IDR_FRAMES, seed=seed)
    long_seq = seqs["idr_1100"]
    beads = write_cg_tree(os.path.join(root, "idrome_cg", "train"),
                          {"cg_0600": seqs["idr_0600"], "cg_1100_n": long_seq[:120]},
                          IDR_FRAMES, seed=seed + 1)
    beads.update(write_cg_tree(os.path.join(root, "idrome_cg", "val"), {"cg_1100_c": long_seq[-90:]},
                               IDR_FRAMES, seed=seed + 2))
    assert all(512 < n <= 1024 if name == "idr_0600" else 1024 < n <= 2048 for name, n in heavy.items())
    assert max(beads.values()) <= 128, beads
    return dict(heavy=heavy, beads=beads)


@contextlib.contextmanager
def record_sampler_runs():
    """Every `Sampler.sample` call's initial batch and output, and every
    Verlet-cached score the walks build (their rebuild counts): {"runs":
    [(init_graphs, out)], "cached": [NeighborCachedScore]}."""
    from jamun_tpu_torch.models.denoiser import Denoiser
    from jamun_tpu_torch.sampling.sampler import Sampler

    sample, make = Sampler.sample, Denoiser.make_neighbor_cached_score
    seen = {"runs": [], "cached": []}

    def recorded_sample(self, denoiser, batch_sampler, num_batches, init_graphs, *args, **kwargs):
        out = sample(self, denoiser, batch_sampler, num_batches, init_graphs, *args, **kwargs)
        seen["runs"].append((init_graphs, out))
        return out

    def recorded_make(self, *args, **kwargs):
        cached = make(self, *args, **kwargs)
        if cached is not None:
            seen["cached"].append(cached)
        return cached

    Sampler.sample, Denoiser.make_neighbor_cached_score = recorded_sample, recorded_make
    try:
        yield seen
    finally:
        Sampler.sample, Denoiser.make_neighbor_cached_score = sample, make


@contextlib.contextmanager
def nbr_geom_kernel_on():
    """The sample CLI's model with `nbr_geom_kernel=True` (K7 for the cached
    lists' edge features; JAX's `JAMUN_NBR_GEOM_KERNEL=1`), set on the arch
    the CLI builds: the sample config has no key for it."""
    from jamun_tpu_torch.cmdline import sample as sample_cli

    build = sample_cli.build_denoiser

    def built(*args, **kwargs):
        den = build(*args, **kwargs)
        den.arch.nbr_geom_kernel = True
        return den

    sample_cli.build_denoiser = built
    try:
        yield
    finally:
        sample_cli.build_denoiser = build


def check_idrome_train_launches(label: str, launches: dict, kabsch: int, calls: dict) -> None:
    """The kernels each phase 8 training run must launch, and no other. The
    IDRome chains (N >= 512) train on the plain sparse path and validate
    on K6, six launches per forward without a gradient (uvw: no kernel);
    the beads (N <= 128) take K1 once and K2 six times per forward and K4
    six times per train step. The Kabsch kernel aligns every batch, the
    validation's included."""
    used = {k: v for k, v in launches.items() if v}
    forwards = calls["grad"] + calls["no_grad"]
    if label == "separable":
        want = {"nbr_conv": 6 * calls["no_grad"]}
    elif label == "uvw":
        want = {}
    else:
        want = {"edge_features": forwards, "conv_block": 6 * forwards, "conv_block_bwd": 6 * calls["grad"]}
    assert calls["grad"] == IDR_STEPS and calls["no_grad"] == IDR_VAL_BATCHES, (label, calls)
    assert used == want, (label, used, want, calls)
    assert kabsch == forwards, (label, kabsch, calls)


def check_idrome_sample_launches(label: str, launches: dict, calls: dict, k7: int) -> None:
    """A sample_idrome run: K6 six times per denoiser call, K7 `k7` times,
    every other kernel never."""
    want = dict.fromkeys(launches, 0)
    want["nbr_conv"] = 6 * calls["no_grad"]
    want["nbr_edge_features"] = k7
    assert launches == want, (label, launches, want)


def idrome_train_runs(dev, card: str, counters: dict, kabsch_kernel, data: dict) -> dict:
    """Phase 8, training: `IDR_TRAIN_RUNS` through the train CLI in process
    (in the work directory of `idrome_workdir`), each `IDR_STEPS` steps and
    one validation, launch counts zeroed before each run and read after."""
    import statistics

    from jamun_tpu_torch.cmdline import train as train_cli

    out = {}
    for label, (exp, run_key, extra, batch) in IDR_TRAIN_RUNS.items():
        args = ["--experiment-dir", EXP_DIR, f"experiment={exp}", f"trainer.max_steps={IDR_STEPS}",
                f"trainer.val_every_n_steps={IDR_STEPS}", "trainer.log_every_n_steps=1",
                f"trainer.val_max_batches={IDR_VAL_BATCHES}", f"data.datamodule.batch_size={batch}",
                *extra]
        for k in (*counters.values(), kabsch_kernel):
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with count_forwards() as calls:
            state = train_cli.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {name: k.launches for name, k in counters.items()}
        kabsch = kabsch_kernel.launches
        check_idrome_train_launches(label, launches, kabsch, calls)
        train, val = read_metrics_csv(os.path.join("runs", run_key, "metrics.csv"))
        losses = [r["train/loss"] for r in train]
        assert state.step == IDR_STEPS and [r["step"] for r in train] == list(range(1, IDR_STEPS + 1))
        assert [r["step"] for r in val] == [IDR_STEPS], val
        assert all(math.isfinite(v) for v in losses + [r["val/loss"] for r in val]), losses
        assert (label == "cg") == hasattr(state.module, "SimpleAtomEmbedding_0"), label
        ms_step = statistics.median((b["time"] - a["time"]) * 1e3 for a, b in zip(train, train[1:]))
        sizes = data["beads"] if label == "cg" else data["heavy"]
        out[label] = dict(
            experiment=exp, run_key=run_key, steps=IDR_STEPS, batch=batch,
            tensor_product=state.module.tensor_product, ms_per_step=ms_step, seconds=seconds,
            peak_bytes=peak, losses=losses, val_loss=[r["val/loss"] for r in val], atoms=sizes,
            launches=launches, kabsch_launches=kabsch, forwards=dict(calls),
        )
        log(f"phase 8: train {label} ({exp}, {state.module.tensor_product}, batch {batch}): "
            f"{ms_step:.3f} ms/step (median gap of metrics.csv's rows, steps 2-{IDR_STEPS}), peak "
            f"device memory {peak / 2**30:.3f} GiB, train loss "
            + " ".join(f"{v:.5f}" for v in losses)
            + f", val loss {val[0]['val/loss']:.5f}; atoms {sizes}; forwards {dict(calls)}; launches "
            f"{ {k: v for k, v in launches.items() if v} }, Kabsch {kabsch}; {seconds:.1f} s in "
            f"main on {card}")
    return out


def idrome_sample_runs(dev, card: str, counters: dict, data: dict) -> dict:
    """Phase 8, sampling: `experiment=sample_idrome` through the sample CLI
    on the separable run (one chain per protein, both padded to the 2048
    bucket, the config's skin-1.0 Verlet lists, every step saved), with
    `nbr_geom_kernel` off and on. K6 six times per denoiser call, K7 once
    per cached score call where the switch is on (the final jump builds its
    own list) and never otherwise, every other kernel never. Returns the
    runs' numbers and the first run's batch at its last step's positions."""
    from jamun_tpu_torch.cmdline import sample as sample_cli

    out, walk_end = {}, None
    root = os.path.join(os.environ["JAMUN_DATA_PATH"], *IDROME_DIR)
    for label, geom in (("separable", False), ("separable_k7", True)):
        run_dir = os.path.join("runs", f"sample_idrome_{label}")
        args = ["--experiment-dir", EXP_DIR, "experiment=sample_idrome",
                "checkpoint_dir=runs/train_idrome_separable/checkpoints",
                f"output_dir={run_dir}/sampler", f"num_batches={IDR_SAMPLE_BATCHES}",
                f"num_sampling_steps_per_batch={IDR_SAMPLE_STEPS}"]
        for k in counters.values():
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            calls = stack.enter_context(count_forwards())
            seen = stack.enter_context(record_sampler_runs())
            metric_time = stack.enter_context(time_metrics())
            if geom:
                stack.enter_context(nbr_geom_kernel_on())
            res = sample_cli.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {name: k.launches for name, k in counters.items()}
        den = res["denoiser"]
        assert den.arch.nbr_geom_kernel == geom and den.arch.tensor_product == "uvu"
        steps, batches = IDR_SAMPLE_STEPS, IDR_SAMPLE_BATCHES
        assert calls == {"grad": 0, "no_grad": batches * (steps + 1)}, calls
        check_idrome_sample_launches(label, launches, calls, batches * steps if geom else 0)
        (init, walked), = seen["runs"]
        init = init.to_device(dev)
        G, N = init.pos.shape[:2]
        assert N == 2048 and G == len(IDR_CHAINS), (G, N)
        assert len(seen["cached"]) == batches, len(seen["cached"])  # one Verlet list per batch
        rebuilds = [int(c.rebuilds) for c in seen["cached"]]
        # the kept slots at the last step's positions (y) of the last batch
        last = torch.zeros_like(init.pos)
        for g, entry in enumerate(walked[-1]):
            last[g, :entry["num_atoms"]] = torch.from_numpy(entry["y_traj"][:, -1]).to(dev)
        end = init.replace_pos(last)
        walk_end = end if walk_end is None else walk_end
        kept = kept_slots(end, den, SIGMA)
        rates = res["rates"]
        assert sorted(rates) == sorted(IDR_CHAINS), rates
        warm = rates["idr_0600"]["time_per_sample_seconds"]
        walk_s = [b["batch_seconds"] for b in res["per_batch"]]
        labels = sorted(IDR_CHAINS)
        on_disk = check_sampler_files(f"{run_dir}/sampler", labels, 1, batches, steps, data["heavy"])
        assert on_disk == len(labels) * batches * steps, on_disk
        for lbl in labels:
            r = res["results"][lbl]
            assert math.isfinite(r["ramachandran_jsd"]) and 0.0 <= r["bond_length_validity_rate"] <= 1.0
        out[label] = dict(
            nbr_geom_kernel=geom, G=G, N=N, batches=batches, steps=steps, seconds=seconds,
            batch_seconds=walk_s, warm_ms_per_step=sum(walk_s[1:]) * 1e3 / ((batches - 1) * steps),
            warm_ms_per_sample=warm * 1e3, rebuilds=rebuilds, kept_slots_last_frame=kept,
            peak_bytes=peak, launches=launches, forwards=dict(calls),
            metric_seconds=metric_time["seconds"], run_dir=run_dir,
        )
        log(f"phase 8: sample_idrome {label} (nbr_geom_kernel={geom}): G={G} N={N}, {batches} x "
            f"{steps} steps; warm {out[label]['warm_ms_per_step']:.3f} ms/step, "
            f"{out[label]['warm_ms_per_sample']:.6f} ms/sample (sampling_times.csv), batches "
            + " ".join(f"{t:.3f}" for t in walk_s) + f" s; Verlet rebuilds per batch {rebuilds}; "
            f"kept slots at the last frame {kept}; launches K6 {launches['nbr_conv']}, K7 "
            f"{launches['nbr_edge_features']}, others none; metrics on the host "
            f"{metric_time['seconds']:.3f} s; peak device memory {peak / 2**30:.3f} GiB; "
            f"{seconds:.1f} s in main on {card}")
    return out, walk_end


def idrome_analysis(card: str, sample: dict) -> dict:
    """Phase 8, analysis: `analysis_sweep` of the first sample run against
    the `.xtc` references (IDRome's suffixes). The sweep keeps JAX's
    behaviour of writing a label's exception as {"error": ...}, so the
    summary is checked: no error, and every label has its TICA and MSM
    JSDs (the stage JAX skips on a caught failure)."""
    from jamun_tpu_torch.analysis import analysis_sweep

    root = os.path.join(os.environ["JAMUN_DATA_PATH"], *IDROME_DIR)
    out_dir = "analysis_idrome"
    t0 = time.perf_counter()
    analysis_sweep.main(["--run-dir", sample["separable"]["run_dir"], "--reference-dir", root,
                         "--ref-traj-suffix", "/traj.xtc", "--ref-pdb-suffix", "/top.pdb",
                         "--out", out_dir])
    seconds = time.perf_counter() - t0
    with open(os.path.join(out_dir, "summary.json")) as f:
        summary = json.load(f)
    assert sorted(summary) == sorted(IDR_CHAINS), summary
    for label, r in summary.items():
        assert "error" not in r, (label, r)
        assert all(math.isfinite(r[k]) for k in ("tica0_jsd", "msm_state_jsd", "ramachandran_jsd")), r
        assert r["num_ref_frames"] == IDR_FRAMES, r
    log(f"phase 8: analysis_sweep against the .xtc references: {seconds:.3f} s on the host; "
        + "; ".join(f"{k}: frames {r['num_pred_frames']} vs {r['num_ref_frames']}, torsion JSD "
                    f"{r['torsion_jsd_mean']:.4f}, TICA-0 JSD {r['tica0_jsd']:.4f}, MSM state JSD "
                    f"{r['msm_state_jsd']:.4f}" for k, r in sorted(summary.items()))
        + f"; beside {card}")
    return dict(seconds=seconds, summary=summary)


@contextlib.contextmanager
def idrome_workdir():
    """A temporary work directory for phase 8 with the IDRome and
    coarse-grained trees written into it, `JAMUN_DATA_PATH` pointing there
    and the process in it; all three undone on the way out."""
    cwd, env = os.getcwd(), os.environ.get("JAMUN_DATA_PATH")
    tmp = tempfile.TemporaryDirectory()
    try:
        t0 = time.perf_counter()
        data = write_idrome_data(os.path.join(tmp.name, "data"))
        os.environ["JAMUN_DATA_PATH"] = os.path.join(tmp.name, "data")
        os.chdir(tmp.name)
        log(f"phase 8: wrote the IDRome tree (heavy atoms {data['heavy']}, hydrogens in top.pdb, "
            f"{IDR_FRAMES} frames of N(0, 0.02 nm) noise in traj.xtc) and the CA-bead tree (beads "
            f"{data['beads']}, .dcd) in {time.perf_counter() - t0:.1f} s")
        yield data
    finally:
        os.chdir(cwd)
        if env is None:
            os.environ.pop("JAMUN_DATA_PATH", None)
        else:
            os.environ["JAMUN_DATA_PATH"] = env
        tmp.cleanup()


def idrome_runs(dev, card: str, counters: dict, kabsch_kernel):
    """Phase 8: the IDRome regime through the CLIs at full width: train
    (`IDR_TRAIN_RUNS`), sample the separable run (`idrome_sample_runs`) and
    analyse the samples against the `.xtc` references (`idrome_analysis`).
    Returns the numbers, and the shapes to hold this path's kernels on
    against their plain versions: a training batch of the beads (N = 128,
    G = 8: K1, K2, K4) and the sample walk's last frame (N = 2048, G = 2:
    K6, K7)."""
    from jamun_tpu_torch.data.batching import collate
    from jamun_tpu_torch.data.discovery import parse_datasets_from_directory

    with idrome_workdir() as data:
        train = idrome_train_runs(dev, card, counters, kabsch_kernel, data)
        sample, walk_end = idrome_sample_runs(dev, card, counters, data)
        analysis = idrome_analysis(card, sample)
        cg = parse_datasets_from_directory(
            os.path.join(os.environ["JAMUN_DATA_PATH"], "idrome_cg", "train"), r"^(.*)\.dcd",
            r"^(.*)\.pdb")
        batch = IDR_TRAIN_RUNS["cg"][3]
        cg_batch = collate([cg[i % len(cg)][i] for i in range(batch)], num_graphs=batch)
    log(f"phase 8: cuts: synthetic chains (build_peptide, extended, plus noise) in place of the "
        f"IDRome and MDGen sets, {IDR_STEPS} train steps instead of the configs' 300000 / 100000 "
        f"and {IDR_VAL_BATCHES} validation batches instead of 1000 / 50, "
        f"uvw at batch {IDR_TRAIN_RUNS['uvw'][3]} instead of 32 (peak "
        f"{train['uvw']['peak_bytes'] / 2**30:.3f} GiB), {IDR_SAMPLE_BATCHES} x {IDR_SAMPLE_STEPS} "
        f"sampling steps instead of 5 x 10000; on {card}")
    return dict(data=data, train=train, sample=sample, analysis=analysis), cg_batch, walk_end


def main() -> int:
    args = sys.argv[1:]
    out_path = args[args.index("--out") + 1] if "--out" in args else None

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig, normalization_factors
    from jamun_tpu_torch.models.e3conv import E3Conv
    from jamun_tpu_torch.ops.cuda import conv_block as k2
    from jamun_tpu_torch.ops.cuda import conv_block_bwd as k4
    from jamun_tpu_torch.ops.cuda import dense_conv as k89
    from jamun_tpu_torch.ops.cuda import e3_stack as k3
    from jamun_tpu_torch.ops.cuda import edge_features as k1
    from jamun_tpu_torch.ops.cuda import fused_block_tiled as k5
    from jamun_tpu_torch.ops.cuda import kabsch as kb
    from jamun_tpu_torch.ops.cuda import nbr_conv as k6
    from jamun_tpu_torch.ops.cuda import nbr_edge_features as k7
    from jamun_tpu_torch.ops.cuda.build import build_all
    from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler
    from jamun_tpu_torch.utils.testing import make_test_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    # every kernel's launch counter (K8 and K9 share a source, as K2 and its layer mode do)
    counters = {k.name: k for k in (
        k1.KERNEL, k2.KERNEL, k2.LAYER_KERNEL, k3.KERNEL, k4.KERNEL, k5.KERNEL, k6.KERNEL,
        k7.KERNEL, k89.K8, k89.K9,
    )}
    logs = build_all()
    # every source has its phase here (the Kabsch rotation replaces no TPU kernel)
    assert sorted(logs) == sorted({k.source.stem for k in (*counters.values(), kb.KERNEL)}), sorted(logs)
    log(f"phase 1: built {list(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    hmma = tensor_core_counts((k2.KERNEL, k3.KERNEL, k5.KERNEL, k89.K9, k6.KERNEL, k4.KERNEL))
    tiled_shapes = tiled_launch_shapes(k5, k89)
    tiled_shapes.update(sparse_bwd_launch_shapes(k6, k4))
    tiled_shapes.update(edge_launch_shapes(k1, k7))

    config = DenoiserConfig(max_radius=1.0, average_squared_distance=0.5)
    c_in, _, _, c_noise = normalization_factors(SIGMA, config.average_squared_distance)
    dtypes = (torch.bfloat16, torch.float32)
    models = {cdt: E3Conv(tensor_product="uvu", dtype=cdt, device=dev, seed=0) for cdt in dtypes}
    # the same weights (the same seed) with the whole-model kernel on
    stack_models = {cdt: E3Conv(
        tensor_product="uvu", dtype=cdt, fused_stack=True, device=dev, seed=0) for cdt in dtypes}
    # the same weights again, dense at any size ("auto" goes sparse from 512 atoms on)
    dense_models = {cdt: E3Conv(
        tensor_product="uvu", dtype=cdt, neighbor_mode="dense", device=dev, seed=0) for cdt in dtypes}
    # and under JAX's pallas_variant="plane" (K9 in every hidden layer)
    plane_models = {cdt: E3Conv(
        tensor_product="uvu", dtype=cdt, pallas_variant="plane", device=dev, seed=0) for cdt in dtypes}
    for m in (*models.values(), *stack_models.values(), *dense_models.values(), *plane_models.values()):
        m.output_gain.data.fill_(1.0)
        m.requires_grad_(False)
    cutoff = Denoiser(models[torch.float32], config).effective_radial_cutoff(SIGMA) / c_in

    sizes = {"4AA": (44, 256), "5AA": (112, 128), "2AA": (19, 256)}
    batches = {
        label: make_test_batch(
            num_graphs=G, max_nodes=N, nodes_per_graph=[N] * G, max_bonds=2 * N, scale=0.35,
            device=dev,
        )
        for label, (N, G) in sizes.items()
    }

    # ---- phase 2: each kernel against its plain version ----
    results = {"edge_features": [], "conv_block": []}
    gen = torch.Generator(device=dev).manual_seed(1)
    for label in ("4AA", "5AA"):
        batch = batches[label]
        G, N = batch.pos.shape[:2]
        pos = (batch.pos * c_in).contiguous()
        geo = (pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask, cutoff, 32)
        for cdt in (torch.bfloat16, torch.float32):
            tag = f"{label} N={N} G={G} {str(cdt).split('.')[-1]}"
            ef, bf = k1.edge_features(*geo, cdt)
            ef_p, bf_p = k1.edge_features_plain(*geo, cdt)
            adj_mismatch = int((ef[..., 3] != ef_p[..., 3]).sum()) + int((bf[..., 3] != bf_p[..., 3]).sum())
            abs_e, rel_e = map(max, zip(rel_err(ef, ef_p), rel_err(bf, bf_p)))
            assert adj_mismatch == 0, f"K1 {tag}: {adj_mismatch} adjacency entries differ"
            assert rel_e <= TOL[cdt], f"K1 {tag}: rel err {rel_e:.3g} > {TOL[cdt]}"
            n_dense = int(ef[..., 3].sum(dtype=torch.float32))
            n_pairs = n_dense + int(bf[..., 3].sum(dtype=torch.float32))
            k1_bytes = (
                pos.numel() * 4 + batch.node_mask.numel() + batch.bond_src.numel() * 16
                + batch.bond_mask.numel() + (ef.numel() + bf.numel()) * ef.element_size()
            )
            occ = k1.occupancy(G, N, batch.bond_src.shape[1], 32, cdt)
            row = dict(
                shape=tag, max_abs_err=abs_e, max_rel_err=rel_e, tol=TOL[cdt],
                ms=cuda_time_ms(lambda: k1.edge_features(*geo, cdt), 20),
                device_ms=device_time_ms(lambda: k1.edge_features(*geo, cdt)),
                prev_ms=PREV_MS.get(("edge_features", tag)),
                prev_device_ms=PREV_DEVICE_MS.get(("edge_features", tag)),
                plain_ms=cuda_time_ms(lambda: k1.edge_features_plain(*geo, cdt), 3),
                bound_ms=k1_bytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
                dtype=str(cdt), N=N, G=G, registers=occ["registers"],
                ctas_per_sm=occ["ctas_per_sm"], smem_bytes=occ["smem_bytes"], ctas=occ["ctas"],
            )
            results["edge_features"].append(row)
            prev, prev_dev = prev_times(row)
            log(f"phase 2: K1 {tag}: max abs err {abs_e:.3g}, rel {rel_e:.3g} (tol {TOL[cdt]}), "
                f"adjacency equal; kernel {row['ms']:.4f} ms through the wrapper{prev}, "
                f"{row['device_ms']:.4f} on the device alone{prev_dev}; plain {row['plain_ms']:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms; {occ['ctas']} CTAs, {occ['registers']} registers, "
                f"{occ['ctas_per_sm']} CTAs per SM, {occ['smem_bytes']} B shared")

            model = models[cdt]
            for block_name, blk, S, V in (
                ("projector", model.ConvBlock_0, 56, 0),
                ("hidden", model._HiddenLayer_0.ConvBlock_0, 120, 32),
            ):
                x = torch.randn((G, N, S + 3 * V), generator=gen, device=dev).to(cdt)
                conv = blk.Conv_0
                w = k2.pack_block_weights(
                    conv.radial_nn, conv._post_linear, blk.IrrepsLinear_1, blk.IrrepsLinear_0,
                    model.embed_bondedness[0], model.embed_bondedness[1], S=S, V=V, cdt=cdt,
                )
                args_k2 = (x, ef, bf, batch.bond_src, batch.bond_dst, w)
                got = k2.fused_conv_block(*args_k2)
                want = k2.fused_conv_block_plain(*args_k2)
                torch.cuda.synchronize()
                assert torch.isfinite(got).all(), f"K2 {block_name} {tag}: non-finite output"
                abs_e, rel_e = rel_err(got, want)
                assert rel_e <= TOL[cdt], f"K2 {block_name} {tag}: rel err {rel_e:.3g} > {TOL[cdt]}"
                Wd = 2 * S + 3 * V
                Sc, Vg = w.Sc, w.Vg
                flops = 2 * n_pairs * (32 * 64 + 64 * Wd) + 2 * G * N * (
                    (S + V) * (Sc + Vg) + 3 * (S + 2 * V) * Vg + Sc * Sc + 3 * Vg * Vg
                    + S * Sc + 3 * V * Vg
                )
                k2_bytes = (
                    (x.numel() + bf.numel()) * x.element_size() + ef_bytes(ef, n_dense)
                    + batch.bond_src.numel() * 16 + got.numel() * 4
                    + sum(t.numel() * t.element_size() for t in w if torch.is_tensor(t))
                )
                t_ops = flops / PEAK_FLOPS[cdt] * 1e3
                t_bytes = k2_bytes / PEAK_BYTES_PER_S * 1e3
                occ = k2.occupancy(N, batch.bond_src.shape[1], S, V, Sc, Vg, cdt)
                assert occ["smem_bytes"] == k2.smem_bytes(N, batch.bond_src.shape[1], S, V, Sc, Vg, cdt)
                row = dict(
                    shape=f"{block_name} {tag}", max_abs_err=abs_e, max_rel_err=rel_e, tol=TOL[cdt],
                    ms=cuda_time_ms(lambda: k2.fused_conv_block(*args_k2), 10),
                    prev_ms=PREV_MS[("conv_block", f"{block_name} {tag}")],
                    plain_ms=cuda_time_ms(lambda: k2.fused_conv_block_plain(*args_k2), 2),
                    bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                    visited_pairs=n_pairs, flops=flops, dtype=str(cdt), N=N, G=G, block=block_name,
                    registers=occ["registers"], spill_bytes=occ["spill_bytes"],
                    ctas_per_sm=occ["ctas_per_sm"], smem_bytes=occ["smem_bytes"], threads=occ["threads"],
                )
                results["conv_block"].append(row)
                log(f"phase 2: K2 {block_name} {tag}: max abs err {abs_e:.3g}, rel {rel_e:.3g} "
                    f"(tol {TOL[cdt]}); kernel {row['ms']:.4f} ms (before the redesign: {row['prev_ms']:.4f}), "
                    f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                    f"{n_pairs} visited pairs; {occ['registers']} registers, {occ['spill_bytes']} spill "
                    f"bytes, {occ['smem_bytes']} B shared, {occ['ctas_per_sm']} CTAs per SM")
                del got, want
            del ef, bf, ef_p, bf_p
            torch.cuda.empty_cache()

    results["e3_stack"] = check_e3_stack(k1, k3, models, stack_models, dev, c_in, c_noise, cutoff)
    results["fused_block_tiled"] = check_fused_block_tiled(
        k1, k2, k5, models, batches, dev, c_in, cutoff
    )
    results.update(check_nbr_kernels(k6, k7, models, dev, c_in, cutoff))
    k7_against_k1 = check_nbr_against_dense(k1, k7, batches, dev, c_in, cutoff)
    dense_rows = check_dense_conv(k89, models, batches, dev, c_in, cutoff)
    for name in ("packed_uvu_conv_dense", "fused_uvu_conv_dense"):
        results[name] = [r for r in dense_rows if r["kernel"] == name]
    results["conv_layer"] = check_conv_layer(k1, k2, models, batches, dev, c_in, cutoff)
    kabsch = check_kabsch(kb, dev)

    # ---- phase 3: the main paths, walk-jump at full flagship width ----
    # (a) the stack path through `Sampler.sample`
    den_stack = Denoiser(stack_models[torch.bfloat16], config)
    for k in (k1, k2, k3):
        k.KERNEL.launches = 0
    walks, stack_calls = stack_walks(den_stack, batches, dev, card)
    launches = {"e3_stack": k3.KERNEL.launches}
    log(f"phase 3: stack path launches {launches} over {stack_calls} denoiser calls; "
        f"K1 {k1.KERNEL.launches}, K2 {k2.KERNEL.launches}")
    assert launches["e3_stack"] == stack_calls, (launches, stack_calls)
    assert k1.KERNEL.launches == 0 and k2.KERNEL.launches == 0

    # (b) the layerwise path (4AA for comparison; 5AA is beyond the stack kernel)
    den = Denoiser(models[torch.bfloat16], config)
    for k in (k1, k2, k3):
        k.KERNEL.launches = 0
    score_calls = 0
    for label in ("4AA", "5AA"):
        batch = batches[label]
        G, N = batch.pos.shape[:2]
        steps = 101
        mcmc = BAOAB(MCMCConfig(delta=0.04, friction=1.0, M=1.0, steps=steps,
                                save_every_n_steps=1, score_fn_clip=100.0))
        sampler = SingleMeasurementSampler(mcmc, SIGMA)
        g = torch.Generator(device=dev).manual_seed(2)
        mask = batch.node_mask[..., None].float()
        y0 = batch.pos + SIGMA * torch.randn(batch.pos.shape, generator=g, device=dev) * mask
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sampler.walk_jump(den, batch, y0, g)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        score_calls += steps + 1  # the walk's initial score, steps - 1 updates, the final jump
        frames = out["xhat_traj"].shape[0]
        assert out["xhat_traj"].shape == (mcmc.config.num_saved_frames, G, N, 3)
        for k in ("y", "xhat", "y_traj", "xhat_traj"):
            assert torch.isfinite(out[k]).all(), f"{label}: non-finite {k}"
        ms_per_sample = dt * 1e3 / (G * frames)
        walks[label] = dict(N=N, G=G, steps=steps, frames=frames, seconds=dt,
                            ms_per_step=dt * 1e3 / steps, ms_per_sample=ms_per_sample)
        log(f"phase 3: walk-jump {label} N={N} G={G} steps={steps}: {dt:.3f} s, "
            f"{ms_per_sample:.6f} ms/sample, {dt * 1e3 / steps:.3f} ms/step on {card}")
    launches.update(edge_features=k1.KERNEL.launches, conv_block=k2.KERNEL.launches)
    log(f"phase 3: layerwise path launches K1 {launches['edge_features']}, "
        f"K2 {launches['conv_block']} over {score_calls} score calls")
    assert launches["edge_features"] == score_calls, launches
    assert launches["conv_block"] == 6 * score_calls, launches
    assert k3.KERNEL.launches == 0

    # (c) the dense path above 128 atoms (K5), through `Sampler.sample`
    forward_kernels = {name: k for name, k in counters.items() if name != "conv_block_bwd"}
    den_tiled = Denoiser(models[torch.bfloat16], config)
    for k in forward_kernels.values():
        k.launches = 0
    tiled, tiled_calls, tiled_launches, batch256, batch256_end = tiled_walks(
        {"N256": den_tiled, "N512": Denoiser(dense_models[torch.bfloat16], config)}, dev, card,
        forward_kernels,
    )
    walks.update(tiled)
    launches["fused_block_tiled"] = tiled_launches
    log(f"phase 3: tiled path launches K5 {launches['fused_block_tiled']} over {tiled_calls} "
        f"denoiser calls; K1 {k1.KERNEL.launches}, K2 {k2.KERNEL.launches}, K3 {k3.KERNEL.launches}")
    assert launches["fused_block_tiled"] == 6 * tiled_calls, (launches, tiled_calls)
    assert k1.KERNEL.launches == 0 and k2.KERNEL.launches == 0 and k3.KERNEL.launches == 0
    # K5 once more against its plain version, at the density the walk ended at
    results["fused_block_tiled"] += check_fused_block_tiled(
        k1, k2, k5, models, batches, dev, c_in, cutoff, shapes={"N256 walk end": batch256_end}
    )
    del batch256_end

    # (d) the sparse path ("auto" from 512 atoms on, no gradient): K6, and K7
    # with `nbr_geom_kernel`, through `Sampler.sample`
    geom_model = E3Conv(
        tensor_product="uvu", dtype=torch.bfloat16, nbr_geom_kernel=True, device=dev, seed=0)
    geom_model.output_gain.data.fill_(1.0)
    geom_model.requires_grad_(False)
    den_sparse = Denoiser(models[torch.bfloat16], config)
    sparse, sparse_launches, batch512_end = sparse_walks(
        den_sparse, Denoiser(geom_model, config), dev, card, counters
    )
    walks.update(sparse)
    launches.update(sparse_launches)
    # K6 and K7 once more against their plain versions, at the load the
    # cached N = 512 walk ends at
    for name, rows in check_nbr_kernels(
        k6, k7, models, dev, c_in, cutoff, shapes={"N512 walk end": (batch512_end, True)},
    ).items():
        results[name] += rows
    del geom_model, batch512_end

    # (e) walk-jump under pallas_variant="plane" (K9 in each hidden layer),
    # through `Sampler.sample`; (f) Conv-level calls that reach K8 and K2's
    # layer mode
    den_plane = Denoiser(plane_models[torch.bfloat16], config)
    plane, launches["fused_uvu_conv_dense"] = plane_walks(den_plane, batches, dev, card, counters)
    walks.update(plane)
    conv_calls = conv_level_calls(models, batches["4AA"], dev, c_in, cutoff, counters)
    launches["packed_uvu_conv_dense"] = sum(
        c["launches"].get("packed_uvu_conv_dense", 0) for c in conv_calls.values()
    )
    launches["conv_layer"] = sum(c["launches"].get("conv_layer", 0) for c in conv_calls.values())

    # ---- phase 4: the output against references ----
    small = make_test_batch(num_graphs=2, max_nodes=44, nodes_per_graph=[44, 41], max_bonds=88,
                            scale=0.35, device=dev)
    ref_model = E3Conv(tensor_product="uvu", dtype=None, device="cpu", plain=True)
    ref_model.load_state_dict(models[torch.float32].state_dict())
    ref_model.requires_grad_(False)
    with torch.no_grad():
        s_cpu = Denoiser(ref_model, config).score(small.to("cpu"), SIGMA)
    q, r = torch.linalg.qr(torch.randn(3, 3, generator=torch.Generator().manual_seed(5)))
    R = (q * torch.sign(torch.diagonal(r))).to(dev)
    if torch.det(R) < 0:
        R = -R
    shift = torch.tensor([0.3, -0.2, 0.5], device=dev)
    mask = small.node_mask[..., None].float()
    for path, by_dtype in (("layerwise", models), ("stack", stack_models)):
        before = (k1.KERNEL.launches, k3.KERNEL.launches)
        with torch.no_grad():
            s_card = Denoiser(by_dtype[torch.float32], config).score(small, SIGMA)
        abs_e, rel_e = rel_err(s_card.cpu(), s_cpu)
        log(f"phase 4: f32 score, {path} kernel path on the card vs plain path on the CPU: "
            f"max abs err {abs_e:.3g}, rel {rel_e:.3g} (tol 1e-3)")
        assert rel_e < 1e-3
        for cdt, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
            d = Denoiser(by_dtype[cdt], config)
            with torch.no_grad():
                s = d.score(small, SIGMA)
                s_rot = d.score(small.replace_pos((small.pos @ R.T + shift) * mask), SIGMA)
            err = ((s_rot - (s @ R.T - shift / SIGMA**2) * mask).abs().max() / s.abs().max()).item()
            log(f"phase 4: E(3) check, {path} path, {str(cdt).split('.')[-1]}: "
                f"|score(Ry+t) - (R score(y) - t/sigma^2)| / max|score| = {err:.3g} (tol {tol})")
            assert err < tol
        # five score calls, each through this path's kernels and not the other's
        used = (k1.KERNEL.launches - before[0], k3.KERNEL.launches - before[1])
        assert used == ((5, 0) if path == "layerwise" else (0, 5)), (path, used)

    tiled_score = check_tiled_score(dense_models, config, dev)
    sparse_score = check_sparse_score(models, config, dev)
    plane_score = check_plane_score(plane_models, config, dev)
    batch512 = chain_batch(512, 8, dev)
    check_walk_never_waits(den, batches["4AA"], dev, "layerwise 4AA")
    check_walk_never_waits(den_stack, batches["4AA"], dev, "stack 4AA")
    check_walk_never_waits(den_tiled, batch256, dev, "tiled N=256")
    check_walk_never_waits(den_sparse, batch512, dev, "sparse N=512 cached", skin=NBR_SKIN)
    check_walk_never_waits(den_sparse, batch512, dev, "sparse N=512 uncached")
    check_walk_never_waits(den_plane, batches["4AA"], dev, "plane 4AA")
    train_waits = check_train_never_waits(dev)
    walk_profile = profile_walk(den, batches["4AA"], dev, 6, "layerwise 4AA")
    stack_profile = profile_walk(den_stack, batches["4AA"], dev, 6, "stack 4AA")
    tiled_profile = profile_walk(den_tiled, batch256, dev, 6, "tiled N=256")
    sparse_profile = profile_walk(den_sparse, batch512, dev, 6, "sparse N=512 cached", NBR_SKIN)
    plane_profile = profile_walk(den_plane, batches["4AA"], dev, 6, "plane 4AA")
    del batches, batch256, batch512, den, den_stack, den_tiled, den_sparse, den_plane
    torch.cuda.empty_cache()

    # ---- phase 5: training, the ConvBlock backward ----
    results["conv_block_bwd"] = check_conv_block_bwd(k2, k4, models, dev, TOL)
    train = train_flagship(dev, card)
    launches["conv_block_bwd"] = train["launches"]["conv_block_bwd"]
    kabsch["launches"] = train["launches"]["kabsch"]
    grad_err = check_train_gradients(dev)
    train_tiled = train_above_128(dev, card, counters)
    train_nbr = train_sparse(dev, card, counters)

    # ---- phases 6 and 7: the training CLI on the repo's 4AA config, then
    # the sample CLI on its runs ----
    with cli_workdir() as (work, atoms):
        train_cli = train_cli_runs(dev, card, counters, kb.KERNEL, work, atoms)
        sample_cli = sample_cli_runs(dev, card, counters, kb.KERNEL, work, atoms)
        # ---- phase 9: Ophiuchus trained and sampled, VESDE on both runs ----
        oph_train = ophiuchus_train_run(dev, card, counters, kb.KERNEL, work, atoms)
        oph_sample = ophiuchus_vesde_sample_runs(dev, card, counters, kb.KERNEL, work, atoms)
        # (d) UnrolledBAOAB on the stack path
        unrolled = unrolled_walk(Denoiser(stack_models[torch.bfloat16], config), dev, card, counters)
        torch.cuda.empty_cache()
        # ---- phase 10: the experimental product, general l, attention and EquiFold ----
        phase10 = dict(train=p10_train_runs(dev, card, counters, kb.KERNEL, work))
        phase10["sample"] = p10_sample_runs(dev, card, counters, kb.KERNEL, work, atoms)
        phase10["modules"] = p10_attention_equifold(dev, card, counters, work)
    torch.cuda.empty_cache()

    # ---- phase 8: the IDRome regime through the CLIs (train, sample, analyse) ----
    idrome, cg_batch, walk_end = idrome_runs(dev, card, counters, kb.KERNEL)
    # this path's kernels against their plain versions at its shapes: K1, K2
    # and K4 on the beads' training batch, K6 and K7 at the walk's last frame
    results["conv_block_bwd"] += check_conv_block_bwd(
        k2, k4, models, dev, TOL, shapes={"IDRome CG": cg_batch})
    for name, rows in check_nbr_kernels(
        k6, k7, models, dev, c_in, cutoff, shapes={"IDRome walk end": (walk_end, True)},
    ).items():
        results[name] += rows
    del cg_batch, walk_end

    # ---- the report ----
    def main_row(rows, **match):
        return next(r for r in rows if all(r[k] == v for k, v in match.items()))

    k1_main = main_row(results["edge_features"], N=44, dtype=str(torch.bfloat16))
    k2_main = main_row(results["conv_block"], N=44, dtype=str(torch.bfloat16), block="hidden")
    k4_main = main_row(results["conv_block_bwd"], label="train", dtype=str(torch.bfloat16),
                       block="hidden")
    k3_main = main_row(results["e3_stack"], label="4AA", dtype=str(torch.bfloat16))
    k5_main = main_row(results["fused_block_tiled"], label="N256", dtype=str(torch.bfloat16),
                       block="hidden")
    k6_main = main_row(results["nbr_conv"], label="N512 cached", dtype=str(torch.bfloat16),
                       block="hidden", variant="A64")
    k7_main = main_row(results["nbr_edge_features"], label="N512 cached", dtype=str(torch.bfloat16))
    k8_main, k9_main = (
        main_row(results[name], label="4AA", dtype=str(torch.bfloat16), block="hidden")
        for name in ("packed_uvu_conv_dense", "fused_uvu_conv_dense")
    )
    layer_main = main_row(results["conv_layer"], label="4AA", dtype=str(torch.bfloat16))
    # K1's and K2's errors on the training batches, measured in K4's check
    also = {"edge_features": ("k1_abs_err",), "conv_block": ("k2_out_abs_err",)}
    kernels = []
    for name, main, replaces in (
        ("edge_features", k1_main, "jamun_tpu/ops/pallas/packed_conv.py:806"),
        ("conv_block", k2_main, "jamun_tpu/ops/pallas/packed_conv.py:1495"),
        ("e3_stack", k3_main, "jamun_tpu/ops/pallas/e3_stack.py:367"),
        ("conv_block_bwd", k4_main, "jamun_tpu/ops/pallas/packed_conv.py:2220"),
        ("fused_block_tiled", k5_main, "jamun_tpu/ops/pallas/packed_conv.py:2819"),
        ("nbr_conv", k6_main, "jamun_tpu/ops/pallas/nbr_conv.py:371"),
        ("nbr_edge_features", k7_main, "jamun_tpu/ops/pallas/nbr_conv.py:559"),
        ("packed_uvu_conv_dense", k8_main, "jamun_tpu/ops/pallas/packed_conv.py:515"),
        ("fused_uvu_conv_dense", k9_main, "jamun_tpu/ops/pallas/fused_conv.py:317"),
        # the same pallas_call with fuse_block=False
        ("conv_layer", layer_main, "jamun_tpu/ops/pallas/packed_conv.py:1495"),
    ):
        kernels.append(dict(
            name=name, route="cuda", replaces=replaces,
            source=f"jamun_tpu_torch/csrc/{counters[name].source.name}",
            launches=launches[name],
            max_abs_err=max([r["max_abs_err"] for r in results[name]]
                            + [r[k] for r in results["conv_block_bwd"] for k in also.get(name, ())]),
            ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=None,
        ))
    report = dict(card=card, compare=results, walks=walks, walk_profile=walk_profile,
                  stack_walk_profile=stack_profile, tiled_walk_profile=tiled_profile,
                  sparse_walk_profile=sparse_profile, tiled_score=tiled_score,
                  sparse_score=sparse_score, plane_walk_profile=plane_profile,
                  plane_score=plane_score, conv_level_calls=conv_calls, train_sync=train_waits,
                  launches=launches, train=train,
                  train_grad_rel_err=grad_err, train_above_128=train_tiled, train_sparse=train_nbr,
                  kabsch=kabsch, hmma=hmma, tiled_launch_shapes=tiled_shapes,
                  k7_against_k1=k7_against_k1, train_cli=train_cli, sample_cli=sample_cli,
                  idrome=idrome, ophiuchus_train=oph_train, ophiuchus_vesde_sample=oph_sample,
                  unrolled=unrolled, phase10=phase10)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    log("walks: " + json.dumps(walks))
    # the Kabsch rotation replaces no TPU kernel: its line of its own
    print(json.dumps({"kabsch": {k: kabsch[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "svd_ms")}}), flush=True)
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
