"""Walk-jump sampling: a Langevin walk in noised space, then the denoiser jump.

Counterpart of `jamun_tpu/sampling/walkjump.py`. With `fused_jump` (the
default, BAOAB only) the jump of the saved frames costs no denoiser forward:
BAOAB saves the raw score at every saved state, and
score(y) = (xhat(y) - y) / sigma^2, so xhat = y + sigma^2 * score. ABOBA
saves the midpoint score, so its frames go through `denoiser.xhat` again,
`jump_chunk_size` frames per call. The final state is always jumped with one
forward.

`sample_chunked` with `offload_chunk_steps` is the host-offload walk: chunks
of that many updates, each chunk's saved frames copied to host memory before
the next chunk runs, so a long trajectory never has to fit on the card. The
chunk boundary is exact for BAOAB (its carried score is a function of y and
is evaluated again at the chunk's start), and frames stay on the unchunked
walk's absolute save grid.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.sampling.mcmc import BAOAB, _SplittingSampler
from jamun_tpu_torch.utils.trace import span

__all__ = ["SingleMeasurementSampler"]

_TRAJ_KEYS = ("y_traj", "score_traj", "xhat_traj")


def _fold_frames(graphs: GraphBatch, frames: torch.Tensor) -> GraphBatch:
    """`graphs` repeated once per frame along the graph axis, with positions
    frames [C, G, N, 3] -> [C * G, N, 3]."""
    C = frames.shape[0]
    folded = graphs.map(lambda t: t.repeat((C,) + (1,) * (t.dim() - 1)))
    return folded.replace_pos(frames.reshape((-1,) + tuple(frames.shape[2:])))


class _HostFrames:
    """Saved frames drained to host memory chunk by chunk. From the card the
    copies go to pinned buffers without blocking the host; `arrays` waits for
    them once at the end."""

    def __init__(self):
        self.chunks = {k: [] for k in _TRAJ_KEYS}
        self.in_flight = False

    def drain(self, out: dict, start: int) -> None:
        for k, parts in self.chunks.items():
            t = out[k][start:]
            if t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                self.in_flight = True
            else:
                host = t
            parts.append(host)

    def arrays(self) -> dict:
        if self.in_flight:
            with span("jamun.host.wait:chunk_drain"):
                torch.cuda.synchronize()
        return {k: np.concatenate([p.numpy() for p in parts]) for k, parts in self.chunks.items()}


@dataclasses.dataclass
class SingleMeasurementSampler:
    """Single-measurement walk-jump sampler. The walk and the jump run with
    autograd off, so no denoiser call in them wants a gradient whatever the
    parameters' `requires_grad` says, and the model stays on its forward-only
    kernels (the stack kernel, and the tiled kernel above 128 atoms)."""

    mcmc: _SplittingSampler
    sigma: float
    jump_chunk_size: int = 0  # frames per denoiser call of the unfused jump (0: all at once)
    fused_jump: bool = True  # take the trajectory jump from the walk's scores (BAOAB)
    offload_chunk_steps: int = 0  # > 0: `sample_chunked` drains frames to the host every N updates
    # > 0: Verlet-cached neighbour lists on the sparse path (nm of the walk's
    # coordinates): the walk carries a list built within cutoff + skin and
    # rebuilds it when some atom moved more than skin / 2, instead of
    # building it at every score call; no effect where the model runs dense
    neighbor_skin: float = 0.0

    @torch.no_grad()
    def walk(self, denoiser, init_graphs: GraphBatch, y_init: torch.Tensor,
             generator: torch.Generator, v_init="gaussian"):
        """The Langevin walk; with a Verlet list the output also holds
        "neighbor_rebuilds", the walk's rebuilds after the first build (a
        device tensor)."""
        mask = init_graphs.node_mask[..., None].to(y_init.dtype)

        def score_fn(y):
            return denoiser.score(init_graphs.replace_pos(y), self.sigma)

        cached = None
        if self.neighbor_skin > 0:
            cached = denoiser.make_neighbor_cached_score(init_graphs, self.sigma, self.neighbor_skin)
        y, v, y_traj, score_traj = self.mcmc(
            y_init, score_fn, generator, v_init=v_init, mask=mask, cached_score=cached
        )
        out = {"y": y, "v": v, "y_traj": y_traj, "score_traj": score_traj}
        if cached is not None:
            out["neighbor_rebuilds"] = cached.rebuilds
        return out

    @torch.no_grad()
    def walk_jump(self, denoiser, init_graphs: GraphBatch, y_init: torch.Tensor,
                  generator: torch.Generator, v_init="gaussian"):
        out = self.walk(denoiser, init_graphs, y_init, generator, v_init)
        with span("jamun.walk.jump"):
            xhat = denoiser.xhat(init_graphs.replace_pos(out["y"]), self.sigma)
            y_traj = out["y_traj"]  # [F, G, N, 3]
            if y_traj.shape[0] == 0:
                xhat_traj = torch.zeros_like(y_traj)
            elif self.fused_jump and isinstance(self.mcmc, BAOAB):
                xhat_traj = y_traj + (self.sigma**2) * out["score_traj"]
            else:
                chunk = self.jump_chunk_size or y_traj.shape[0]
                parts: List[torch.Tensor] = []
                for frames in y_traj.split(chunk):
                    jumped = denoiser.xhat(_fold_frames(init_graphs, frames), self.sigma)
                    parts.append(jumped.reshape(frames.shape))
                xhat_traj = torch.cat(parts)
        return {**out, "xhat": xhat, "xhat_traj": xhat_traj}

    def sample(self, denoiser, init_graphs: GraphBatch, y_init: torch.Tensor,
               generator: torch.Generator, v_init="gaussian"):
        out = self.walk_jump(denoiser, init_graphs, y_init, generator, v_init)
        out["sample"] = out["xhat"]
        return out

    def sample_chunked(self, denoiser, init_graphs: GraphBatch, y_init: torch.Tensor,
                       generator: torch.Generator, v_init="gaussian"):
        """`sample` with host offload: the walk runs in chunks of
        `offload_chunk_steps` updates and each chunk's trajectories go to
        host numpy arrays before the next chunk runs. Frames land on the
        absolute save grid of the unchunked walk (a chunk's initial frame,
        which repeats the previous chunk's last one, is dropped). The final
        state, velocity and sample stay tensors."""
        cfg = self.mcmc.config
        C = self.offload_chunk_steps
        total = max(cfg.steps - 1, 0)
        host = _HostFrames()
        if C <= 0 or total <= C:
            out = self.sample(denoiser, init_graphs, y_init, generator, v_init)
            host.drain(out, 0)
            return {**out, **host.arrays()}
        if cfg.burn_in_steps != 0:
            raise NotImplementedError(
                "offload_chunk_steps requires burn_in_steps == 0, as in the JAX package "
                "(ROADMAP.md queue A, 'Offloaded walks with burn-in')"
            )
        if C % cfg.save_every_n_steps != 0:
            raise ValueError("offload_chunk_steps must be a multiple of save_every_n_steps")

        def sub(updates: int) -> "SingleMeasurementSampler":
            sub_cfg = dataclasses.replace(cfg, steps=updates + 1)
            return dataclasses.replace(self, mcmc=type(self.mcmc)(sub_cfg), offload_chunk_steps=0)

        n_chunks, rem = divmod(total, C)
        chunks = [sub(C)] * n_chunks + ([sub(rem)] if rem else [])
        y, v, out = y_init, v_init, None
        for c, chunk in enumerate(chunks):
            out = chunk.walk_jump(denoiser, init_graphs, y, generator, v)
            y, v = out["y"], out["v"]
            host.drain(out, 0 if c == 0 else 1)
        return {**host.arrays(), "y": y, "v": v, "xhat": out["xhat"], "sample": out["xhat"]}
