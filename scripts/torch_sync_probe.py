"""Which steps of the port's training step make the host wait for the card.

Run on a machine with an NVIDIA GPU, from the repository root:
    python3 scripts/torch_sync_probe.py

Each probe runs once under PyTorch's sync debug mode set to raise and
prints whether it raised ("waits") or not ("no wait"): the Kabsch
alignment's linear algebra on a batch of 3 x 3 matrices (`torch.linalg.svd`
and `torch.linalg.det`), `ops.geometry.kabsch_align` itself, and one
`train_step` of the flagship model in bf16 with and without
`align_noisy_input_during_training` (a mirror flip and one fixed noise draw
in both). Prints the card's name and power limit first; exits non-zero
without a card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def waits(fn) -> str:
    """'waits' when `fn` makes a synchronizing CUDA call, else 'no wait'."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as err:
        if "synchronizing" not in str(err):
            raise
        return "waits"
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return "no wait"


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_sync_probe: no CUDA device", file=sys.stderr)
        return 2
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from jamun_tpu_torch.models.e3conv import E3Conv
    from jamun_tpu_torch.ops.geometry import kabsch_align
    from jamun_tpu_torch.train.distributions import ConstantSigma
    from jamun_tpu_torch.train.optim import adam
    from jamun_tpu_torch.train.state import create_train_state, make_train_step
    from jamun_tpu_torch.utils.testing import make_test_batch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    h = torch.randn(32, 3, 3, device=dev)
    batch = make_test_batch(num_graphs=32, max_nodes=48, nodes_per_graph=[44] * 32, max_bonds=96,
                            device=dev)
    y = batch.pos + 0.04 * torch.randn(batch.pos.shape, device=dev)
    print(f"torch.linalg.svd: {waits(lambda: torch.linalg.svd(h))}")
    print(f"torch.linalg.det: {waits(lambda: torch.linalg.det(h))}")
    print(f"kabsch_align: {waits(lambda: kabsch_align(y, batch.pos, batch.node_mask))}")
    for align in (True, False):
        den = Denoiser(E3Conv(
            tensor_product="uvu", dtype=torch.bfloat16, device=dev, seed=0), DenoiserConfig(
            max_radius=1.0, average_squared_distance=0.3, mirror_augmentation_rate=0.5,
            add_fixed_noise=True, align_noisy_input_during_training=align,
        ))
        state = create_train_state(den, adam(2.0e-3), device=dev)
        step = make_train_step(den, ConstantSigma(0.04))
        step(state, batch)  # the cached constants
        print(f"train_step, align_noisy_input_during_training={align}: "
              f"{waits(lambda: step(state, batch))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
