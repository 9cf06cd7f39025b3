"""Host time against total time of the port's sampling calls on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:
    python3 scripts/torch_host_overlap.py

For each call (the whole-model kernel's launch alone, the E3Conv forward and
`Denoiser.score` on the stack path and on the layerwise path, at the 4AA walk
shape N = 44, G = 256, and the forward and `Denoiser.score` on the tiled path
above 128 atoms, K5, at N = 256, G = 64; flagship width, bf16) it runs the
call 20 times (5 on the tiled path) and
prints the host's time per call up to the last enqueue and the total time per
call after a synchronise. A call whose host time equals its total time makes
the host wait for the device somewhere (a blocking copy, an `.item()`), so
the host cannot queue the next forward while this one's kernels run; a call
that overlaps shows a host time below the total. Then a 101-step BAOAB walk
on each path (21 steps on the tiled path), in ms per step. The first line is the card's name and power
limit.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SIGMA = 0.04


def host_and_total(fn, reps: int, label: str) -> None:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"{label}: host {1e3 * (t1 - t0) / reps:.3f} ms/call, "
          f"total {1e3 * (t2 - t0) / reps:.3f} ms/call", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_host_overlap: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import tiled_batch
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig, normalization_factors
    from jamun_tpu_torch.models.e3conv import E3Conv
    from jamun_tpu_torch.ops.cuda import e3_stack as k3
    from jamun_tpu_torch.ops.cuda.build import build_all
    from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler
    from jamun_tpu_torch.utils.testing import make_test_batch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    build_all(["edge_features", "conv_block", "e3_stack", "fused_block_tiled"])
    dev = torch.device("cuda")
    config = DenoiserConfig(max_radius=1.0, average_squared_distance=0.5)
    c_in, _, _, c_noise = normalization_factors(SIGMA, config.average_squared_distance)
    models = {
        "stack": E3Conv(
            tensor_product="uvu", dtype=torch.bfloat16, device=dev, seed=0, fused_stack=True),
        "layerwise": E3Conv(tensor_product="uvu", dtype=torch.bfloat16, device=dev, seed=0),
    }
    for m in models.values():
        m.output_gain.data.fill_(1.0)
        m.requires_grad_(False)
    denoisers = {name: Denoiser(m, config) for name, m in models.items()}
    cutoff = denoisers["stack"].effective_radial_cutoff(SIGMA) / c_in
    batch = make_test_batch(num_graphs=256, max_nodes=44, nodes_per_graph=[44] * 256,
                            max_bonds=88, scale=0.35, device=dev)
    scaled = batch.replace_pos((batch.pos * c_in).contiguous())
    cn = torch.full((1,), c_noise, dtype=torch.float32, device=dev)
    stack = models["stack"]
    nf0 = stack.NoiseConditionalScaling_0(stack.AtomEmbeddingWithResidueInformation_0(scaled), cn)
    args = stack._stack_args(scaled, nf0, cn, cutoff)
    host_and_total(lambda: k3.e3conv_stack(*args), 20, "K3 launch alone")
    host_and_total(lambda: stack._stack_args(scaled, nf0, cn, cutoff), 20, "K3's arguments alone")
    for name, model in models.items():
        host_and_total(lambda: model(scaled, cn, cutoff), 20, f"{name} E3Conv forward")
    with torch.no_grad():
        for name, den in denoisers.items():
            host_and_total(lambda: den.score(batch, SIGMA), 20, f"{name} Denoiser.score")
    # the tiled path: the layerwise model above 128 atoms (K5 per block, no K1)
    big = tiled_batch(256, 64, dev)
    big_scaled = big.replace_pos((big.pos * c_in).contiguous())
    layerwise = models["layerwise"]
    host_and_total(lambda: layerwise(big_scaled, cn, cutoff), 5, "tiled N=256 E3Conv forward")
    with torch.no_grad():
        host_and_total(lambda: denoisers["layerwise"].score(big, SIGMA), 5,
                       "tiled N=256 Denoiser.score")
    walks = [(name, den, batch, 101) for name, den in denoisers.items()]
    walks.append(("tiled N=256", denoisers["layerwise"], big, 21))
    for name, den, walk_batch, steps in walks:
        sampler = SingleMeasurementSampler(
            BAOAB(MCMCConfig(delta=0.04, steps=steps, score_fn_clip=100.0)), SIGMA
        )
        gen = torch.Generator(device=dev).manual_seed(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.walk_jump(den, walk_batch, walk_batch.pos, gen)
        torch.cuda.synchronize()
        print(f"{name} walk: {(time.perf_counter() - t0) * 1e3 / steps:.3f} ms/step", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
