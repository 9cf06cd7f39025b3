"""The sampling loop: a host loop over sample batches around one walk-jump per
batch, with chain continuation and observer callbacks.

Counterpart of `jamun_tpu/sampling/sampler.py`. The denoiser holds its own
parameters, so `sample` takes no parameter tree; `seed` makes an explicit
`torch.Generator` on the sampler's device. JAX's `donate_state` (buffer
donation into the jitted batch program) has no counterpart: PyTorch frees a
batch's tensors when the next batch replaces them. Chains over several
devices and atom sharding are not ported (ROADMAP.md queue A, 'Parallel').
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.utils.device import resolve_device

__all__ = ["Sampler", "unbatch_samples"]


def _host(value) -> np.ndarray:
    return value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)


def unbatch_samples(samples: Dict[str, Any], init_graphs: GraphBatch) -> List[Dict[str, Any]]:
    """Split stacked outputs into per-graph host dicts.

    Trajectory arrays [frames, G, N, 3] become per-graph [atoms, frames, 3];
    final-state arrays [G, N, 3] become [atoms, 3]. Padding atoms are
    stripped, graphs with `graph_mask` false left out."""
    node_mask, graph_mask = _host(init_graphs.node_mask), _host(init_graphs.graph_mask)
    host = {k: _host(v) for k, v in samples.items() if hasattr(v, "shape")}
    G = node_mask.shape[0]
    out: List[Dict[str, Any]] = []
    for g in range(G):
        if not graph_mask[g]:
            continue
        n = int(node_mask[g].sum())
        entry: Dict[str, Any] = {"graph_index": g, "num_atoms": n}
        for key, value in host.items():
            if value.ndim == 4 and value.shape[1] == G:  # [frames, G, N, 3]
                entry[key] = np.transpose(value[:, g, :n], (1, 0, 2))
            elif value.ndim == 3 and value.shape[0] == G:  # [G, N, 3]
                entry[key] = value[g, :n]
        out.append(entry)
    return out


@dataclasses.dataclass
class Sampler:
    """Runs `num_batches` sampling rounds, optionally continuing the chain.

    Callbacks may define `on_sample_start(sampler)`,
    `on_after_sample_batch(sample, sampler, elapsed_seconds,
    neighbor_overflow)`, `on_sample_end(sampler)` and
    `update_sampler(batch_sampler, batch_idx)` (see `sampling/callbacks.py`).
    `device` follows `utils.device.resolve_device`: the card unless "cpu".
    Where the denoiser runs the sparse path, `neighbor_overflow` is
    {"mean", "max"} over the valid graphs of the in-cutoff edges its cap
    drops at the batch's end positions (one host read per batch, as in
    JAX); None where it runs dense, which drops no edge."""

    callbacks: Sequence[Any] = ()
    num_devices: Optional[int] = None
    mesh: Any = None
    atom_sharded: bool = False
    device: Any = None

    def __post_init__(self):
        if (self.num_devices or 1) > 1 or self.mesh is not None or self.atom_sharded:
            raise NotImplementedError(
                "sampling over several devices (num_devices > 1, mesh, atom_sharded) is "
                "not ported (ROADMAP.md queue A, 'Parallel')"
            )
        self.device = resolve_device(self.device)
        self.global_step = 0

    def _call(self, hook: str, **kwargs):
        for cb in self.callbacks:
            fn = getattr(cb, hook, None)
            if fn is not None:
                fn(**kwargs)

    def sample(
        self,
        denoiser,
        batch_sampler,
        num_batches: int,
        init_graphs: GraphBatch,
        continue_chain: bool = False,
        seed: int = 0,
    ) -> List[List[Dict[str, Any]]]:
        """Per batch, the list of per-graph dicts of `unbatch_samples`."""
        init_graphs = init_graphs.to(self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        pos = init_graphs.pos
        mask = init_graphs.node_mask[..., None].to(pos.dtype)

        def fresh_start():
            noise = torch.randn(pos.shape, generator=generator, dtype=pos.dtype, device=self.device)
            return pos + batch_sampler.sigma * noise * mask

        y_init, v_init = fresh_start(), "gaussian"
        sparse = denoiser.sparse_neighbors_active(pos.shape[1], training=False)
        graph_mask, sigma = init_graphs.graph_mask.cpu().numpy(), batch_sampler.sigma
        self._call("on_sample_start", sampler=self)
        all_samples: List[List[Dict[str, Any]]] = []
        for batch_idx in range(num_batches):
            self.global_step = batch_idx
            for cb in self.callbacks:  # parameter callbacks change the MCMC settings per batch
                if hasattr(cb, "update_sampler"):
                    batch_sampler = cb.update_sampler(batch_sampler, batch_idx)
            chunked = getattr(batch_sampler, "offload_chunk_steps", 0) > 0
            run = batch_sampler.sample_chunked if chunked else batch_sampler.sample
            t0 = time.perf_counter()
            out = run(denoiser, init_graphs, y_init, generator, v_init)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            elapsed = time.perf_counter() - t0

            if continue_chain:
                y_init, v_init = out["y"], out["v"]
            else:
                y_init, v_init = fresh_start(), "gaussian"

            overflow = None
            if sparse:
                with torch.no_grad():
                    ov = denoiser.neighbor_overflow(
                        init_graphs.replace_pos(out["y"]), sigma
                    ).cpu().numpy()
                ov = ov[graph_mask]
                overflow = {
                    "mean": float(ov.mean()) if ov.size else 0.0,
                    "max": int(ov.max()) if ov.size else 0,
                }

            samples = unbatch_samples(out, init_graphs)
            all_samples.append(samples)
            self._call(
                "on_after_sample_batch",
                sample=samples,
                sampler=self,
                elapsed_seconds=elapsed,
                neighbor_overflow=overflow,
            )
        self._call("on_sample_end", sampler=self)
        return all_samples
