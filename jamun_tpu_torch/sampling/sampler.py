"""The sampling loop: a host loop over sample batches around one walk-jump per
batch, with chain continuation and observer callbacks.

Counterpart of `jamun_tpu/sampling/sampler.py`. The denoiser holds its own
parameters, so `sample` takes no parameter tree; `seed` makes an explicit
`torch.Generator` on the sampler's device. JAX's `donate_state` (buffer
donation into the jitted batch program) has no counterpart: PyTorch frees a
batch's tensors when the next batch replaces them.

Over a process group (`parallel/`), as JAX's `Sampler` over a mesh:
`num_devices` > 1 (or a `mesh`) splits the chains, each rank walking its
contiguous slice of the graphs (padded with masked dummy graphs to a
multiple of the ranks) with no collective during the walk; its draws are
its rows of the global draw (`parallel.mesh.GraphShardGenerator`), so the
chains equal the single-process run's. `atom_sharded=True` splits each
molecule's atoms instead (`parallel/atom_sharded.py`): every rank walks the
whole batch and runs its rows of each forward (in one process, the whole
molecule on the same plain path, as JAX's over a one-device mesh). Either way `sample` returns
the full per-graph list on every rank, and only rank 0 runs the callbacks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.parallel.atom_sharded import (
    denoiser_with_atom_sharding,
    pad_atoms_to_multiple,
    prepare_atom_sharded_batch,
)
from jamun_tpu_torch.parallel.distributed import rank
from jamun_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    make_generator,
    make_mesh,
    pad_batch_to_multiple,
    randn_graphs,
    shard_batch,
)
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


def _gather_chains(out: Dict[str, Any], mesh: Mesh, device) -> Dict[str, Any]:
    """Every rank's chains of a batch's outputs: [G, N, 3] arrays along
    axis 0, trajectories [frames, G, N, 3] along axis 1 (host arrays of an
    offloaded walk too); the rest stays."""
    full = dict(out)
    for key, value in out.items():
        ndim = getattr(value, "ndim", 0)
        if ndim in (3, 4):
            on_host = not torch.is_tensor(value)
            t = torch.as_tensor(value, device=device) if on_host else value
            t = all_gather(t, mesh.group, ndim - 3)
            full[key] = t.cpu().numpy() if on_host else t
    return full


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
    mesh: Optional[Mesh] = None
    atom_sharded: bool = False
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.global_step = 0

    def _call(self, hook: str, **kwargs):
        if rank() != 0:
            return
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
        """Per batch, the list of per-graph dicts of `unbatch_samples` (of
        every rank's chains)."""
        mesh, chains = self.mesh, None
        if mesh is None and (self.atom_sharded or (self.num_devices or 1) > 1):
            mesh = make_mesh(self.num_devices)
        if self.atom_sharded:
            denoiser = denoiser_with_atom_sharding(denoiser, mesh)
            init_graphs = prepare_atom_sharded_batch(pad_atoms_to_multiple(init_graphs, mesh.size), mesh)
        elif mesh is not None and mesh.distributed:
            chains = mesh
            init_graphs = pad_batch_to_multiple(init_graphs, mesh.size)
        all_graphs = init_graphs.to(self.device)
        init_graphs = all_graphs if chains is None else shard_batch(all_graphs, chains)
        generator = make_generator(self.device, seed, chains)
        pos = init_graphs.pos
        mask = init_graphs.node_mask[..., None].to(pos.dtype)

        def fresh_start():
            noise = randn_graphs(pos.shape, generator, pos.dtype, self.device)
            return pos + batch_sampler.sigma * noise * mask

        y_init, v_init = fresh_start(), "gaussian"
        sparse = denoiser.sparse_neighbors_active(pos.shape[1], training=False)
        graph_mask, sigma = all_graphs.graph_mask.cpu().numpy(), batch_sampler.sigma
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

            if chains is not None:
                out = _gather_chains(out, chains, self.device)
            overflow = None
            if sparse and rank() == 0:
                with torch.no_grad():
                    ov = denoiser.neighbor_overflow(
                        all_graphs.replace_pos(out["y"]), sigma
                    ).cpu().numpy()
                ov = ov[graph_mask]
                overflow = {
                    "mean": float(ov.mean()) if ov.size else 0.0,
                    "max": int(ov.max()) if ov.size else 0,
                }

            samples = unbatch_samples(out, all_graphs)
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
