"""Denoiser core: EDM-style preconditioning around an equivariant arch
(E3Conv or Ophiuchus).

Counterpart of `jamun_tpu/models/denoiser.py:30-146` (the sampling side):

  A = average_squared_distance, B = 2 * D * sigma^2
  c_in = 1/sqrt(A+B), c_skip = A/(A+B), c_out = sqrt(A*B/(A+B)), c_noise = log(sigma)/4
  effective_radial_cutoff = sqrt(max_radius^2 + 6 sigma^2)
  xhat = c_skip * y + c_out * g(c_in * y, c_noise, cutoff / c_in)
  score = (xhat - y) / sigma^2
  loss  = mean over valid graphs of [ mean_atoms sum_D (xhat - x)^2 ] * loss_weight / c_out^2

sigma is a Python float (one noise level per walk, one per training batch),
so the factors are host scalars and the forward makes no host-device round
trip for them. The training side (`add_noise` ... `training_loss`) is the
counterpart of `jamun_tpu/models/denoiser.py:230-324`; its noise comes from
an explicit `torch.Generator`. The sparse path's helpers
(`sparse_neighbors_active`, `neighbor_overflow`,
`make_neighbor_cached_score`) are those of
`jamun_tpu/models/denoiser.py:150-226`.

Any arch runs, as in JAX's Denoiser: `nbr_cache` and `with_telemetry` go
only to an arch whose `forward` takes them (an arch that reports nothing
gives empty telemetry), and an arch without `neighbor_mode` /
`neighbor_cap` runs dense (cap 32, JAX's default).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import math
from typing import Dict, Optional, Tuple

import torch

from jamun_tpu_torch.models.e3conv import irreps_to_vector, neighbor_mode_auto
from jamun_tpu_torch.ops.geometry import kabsch_align, mean_center
from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.ops.neighbors import capped_neighbor_lists
from jamun_tpu_torch.parallel.mesh import all_reduce_max, all_reduce_sum, global_graph_mean, randn_graphs
from jamun_tpu_torch.sampling.mcmc import NeighborCachedScore

__all__ = ["DenoiserConfig", "Denoiser", "normalization_factors", "loss_weight", "masked_graph_mean"]


def normalization_factors(sigma: float, average_squared_distance: float, D: int = 3):
    A = float(average_squared_distance)
    B = 2.0 * D * float(sigma) ** 2
    c_in = 1.0 / math.sqrt(A + B)
    c_skip = A / (A + B)
    c_out = math.sqrt((A * B) / (A + B))
    c_noise = math.log(float(sigma)) / 4.0
    return c_in, c_skip, c_out, c_noise


def loss_weight(sigma: float, average_squared_distance: float, D: int = 3) -> float:
    """1 / c_out^2."""
    return 1.0 / normalization_factors(sigma, average_squared_distance, D)[2] ** 2


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    max_radius: float
    average_squared_distance: float
    align_noisy_input_during_training: bool = True
    align_noisy_input_during_evaluation: bool = True
    mean_center: bool = True
    mirror_augmentation_rate: float = 0.0
    add_fixed_noise: bool = False  # the same N(0, 1) draw for every graph (seed 0)
    add_fixed_ones: bool = False  # noise of ones: deterministic, for tests
    # stored but not read by the loss, as in the JAX package
    bond_loss_coefficient: float = 1.0


_ARCH_KWARGS = frozenset({"nbr_cache", "with_telemetry"})


@functools.lru_cache(maxsize=None)
def _takes(forward) -> frozenset:
    """The keyword arguments of the Denoiser's that an arch's `forward`
    takes (all of them through **kwargs)."""
    params = inspect.signature(forward).parameters.values()
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params):
        return _ARCH_KWARGS
    return _ARCH_KWARGS & {p.name for p in params}


class Denoiser:
    """Wraps an equivariant arch with the preconditioning; `score` feeds the
    walk."""

    def __init__(self, arch, config: DenoiserConfig):
        self.arch = arch
        self.config = config

    def effective_radial_cutoff(self, sigma: float) -> float:
        return math.sqrt(self.config.max_radius**2 + 6.0 * float(sigma) ** 2)

    def xhat_normalized(
        self, y: GraphBatch, sigma: float, with_telemetry: bool = False, nbr_cache=None
    ):
        """`with_telemetry=True` also returns the arch's telemetry dict
        ("neighbor_overflow" [G] where the sparse path built its lists);
        `nbr_cache` is a Verlet list for the sparse path
        (`make_neighbor_cached_score`)."""
        D = y.pos.shape[-1]
        c_in, c_skip, c_out, c_noise = normalization_factors(
            sigma, self.config.average_squared_distance, D
        )
        radial_cutoff = self.effective_radial_cutoff(sigma) / c_in
        c_noise_t = torch.full((1,), c_noise, dtype=torch.float32, device=y.pos.device)
        takes = _takes(type(self.arch).forward)
        kw = {}
        if "nbr_cache" in takes:
            kw["nbr_cache"] = nbr_cache
        if with_telemetry and "with_telemetry" in takes:
            kw["with_telemetry"] = True
        g_out = self.arch(y.replace_pos(y.pos * c_in), c_noise_t, radial_cutoff, **kw)
        tel = {}
        if "with_telemetry" in kw:
            g_out, tel = g_out
        xhat = c_skip * y.pos + c_out * irreps_to_vector(g_out)
        return (xhat, tel) if with_telemetry else xhat

    def xhat(self, y: GraphBatch, sigma: float, with_telemetry: bool = False, nbr_cache=None):
        pos = y.pos
        if self.config.mean_center:
            pos = mean_center(pos, y.node_mask)
        xhat_pos = self.xhat_normalized(y.replace_pos(pos), sigma, with_telemetry, nbr_cache)
        tel = {}
        if with_telemetry:
            xhat_pos, tel = xhat_pos
        if self.config.mean_center:
            xhat_pos = mean_center(xhat_pos, y.node_mask)
        return (xhat_pos, tel) if with_telemetry else xhat_pos

    def score(self, y: GraphBatch, sigma: float) -> torch.Tensor:
        """score(y, sigma) = (xhat(y) - y) / sigma^2."""
        return (self.xhat(y, sigma) - y.pos) / float(sigma) ** 2

    # ---- the sparse path's telemetry and Verlet lists (sampling side) ----

    def sparse_neighbors_active(self, n_atoms: int, training: bool = False) -> bool:
        """Whether the arch takes the sparse capped-K path at this size (the
        only path that drops edges)."""
        mode = getattr(self.arch, "neighbor_mode", "dense")
        return mode == "nbr" or (mode == "auto" and neighbor_mode_auto(n_atoms, training))

    @property
    def neighbor_cap(self) -> int:
        return int(getattr(self.arch, "neighbor_cap", 32))

    def _scaled_cutoff(self, sigma: float, D: int):
        c_in = normalization_factors(sigma, self.config.average_squared_distance, D)[0]
        return c_in, self.effective_radial_cutoff(sigma) / c_in

    def neighbor_overflow(self, y: GraphBatch, sigma: float) -> torch.Tensor:
        """[G]: the in-cutoff edges the sparse path's cap drops at these
        positions, on the geometry the arch sees (c_in-scaled positions
        against cutoff / c_in). Callers gate on `sparse_neighbors_active`."""
        c_in, cutoff = self._scaled_cutoff(sigma, y.pos.shape[-1])
        pos = mean_center(y.pos, y.node_mask) if self.config.mean_center else y.pos
        return capped_neighbor_lists(pos * c_in, y.node_mask, cutoff, self.neighbor_cap)[2]

    def make_neighbor_cached_score(
        self, batch: GraphBatch, sigma: float, skin: float
    ) -> Optional[NeighborCachedScore]:
        """The walk's Verlet-cached score (`sampling/mcmc.NeighborCachedScore`):
        the capped list within cutoff + skin (skin in the walk's nm), built on
        the arch's geometry, rebuilt when some atom moved more than skin / 2.
        None when skin <= 0, the arch runs dense at this size or takes no
        list."""
        if (
            skin <= 0 or not self.sparse_neighbors_active(batch.pos.shape[1])
            or "nbr_cache" not in _takes(type(self.arch).forward)
        ):
            return None
        c_in, cutoff = self._scaled_cutoff(sigma, batch.pos.shape[-1])

        def rebuild(y):
            idx, superset, _ = capped_neighbor_lists(
                y * c_in, batch.node_mask, cutoff + skin * c_in, self.neighbor_cap
            )
            return idx, superset

        def score(y, cache):
            xhat = self.xhat(batch.replace_pos(y), sigma, nbr_cache=cache)
            return (xhat - y) / float(sigma) ** 2

        return NeighborCachedScore(rebuild=rebuild, score=score, threshold=skin / 2.0)

    # ---- training path ----

    def add_noise(self, x: GraphBatch, sigma: float, generator: torch.Generator) -> GraphBatch:
        """y = x + sigma * noise on real atoms, then a mirror flip of the
        whole batch with probability `mirror_augmentation_rate`."""
        cfg = self.config
        pos = x.pos
        if cfg.add_fixed_ones:
            noise = torch.ones_like(pos)
        elif cfg.add_fixed_noise:
            noise = _fixed_noise(tuple(pos.shape[1:]), pos.device, pos.dtype)[None].expand_as(pos)
        else:
            noise = randn_graphs(pos.shape, generator).to(pos)
        pos = pos + float(sigma) * noise * x.node_mask[..., None].to(pos.dtype)
        if cfg.mirror_augmentation_rate > 0:
            # chosen on the device, as JAX's `jnp.where`: reading the draw on
            # the host would make it wait for every kernel queued before it
            u = torch.rand((), generator=generator, device=generator.device)
            pos = torch.where(u.to(pos.device) < cfg.mirror_augmentation_rate, -pos, pos)
        return x.replace_pos(pos)

    def noise_and_denoise(
        self, x: GraphBatch, sigma: float, generator: torch.Generator, align_noisy_input: bool,
        with_telemetry: bool = False,
    ):
        """(xhat, the noisy y, the centred clean x), and the arch's telemetry
        with `with_telemetry`."""
        if self.config.mean_center:
            x = x.replace_pos(mean_center(x.pos, x.node_mask))
        y = self.add_noise(x, sigma, generator)
        if self.config.mean_center:
            y = y.replace_pos(mean_center(y.pos, y.node_mask))
        if align_noisy_input:
            y = y.replace_pos(kabsch_align(y.pos, x.pos, x.node_mask))
        if with_telemetry:
            xhat_pos, tel = self.xhat(y, sigma, with_telemetry=True)
            return xhat_pos, y, x, tel
        return self.xhat(y, sigma), y, x

    def compute_loss(
        self, x: GraphBatch, xhat_pos: torch.Tensor, sigma: float
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Per-graph scaled loss [G] and a dict of per-graph metrics."""
        pos = x.pos
        if self.config.mean_center:
            pos = mean_center(pos, x.node_mask)
        D = pos.shape[-1]
        m = x.node_mask.to(pos.dtype)
        per_atom = ((xhat_pos - pos) ** 2).sum(-1) * m  # [G, N]
        count = torch.clamp(m.sum(-1), min=1.0)
        raw_loss = per_atom.sum(-1) / count
        scaled_rmsd = (torch.sqrt(per_atom + 1e-20) * m).sum(-1) / count
        scaled_rmsd = scaled_rmsd / (float(sigma) * math.sqrt(D))
        w = loss_weight(sigma, self.config.average_squared_distance, D)
        scaled_loss = raw_loss * x.loss_weight * w
        return scaled_loss, {
            "coordinate_loss": scaled_loss,
            "raw_coordinate_loss": raw_loss,
            "scaled_rmsd": scaled_rmsd,
        }

    def noise_and_compute_loss(
        self, x: GraphBatch, sigma: float, generator: torch.Generator, align_noisy_input: bool,
        with_telemetry: bool = False,
    ):
        """(per-graph loss, aux), and the arch's telemetry with
        `with_telemetry`."""
        out = self.noise_and_denoise(x, sigma, generator, align_noisy_input, with_telemetry)
        per_graph, aux = self.compute_loss(out[2], out[0], sigma)
        return (per_graph, aux, out[3]) if with_telemetry else (per_graph, aux)

    def training_loss(
        self, x: GraphBatch, sigma: float, generator: torch.Generator, mesh=None
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The scalar loss averaged over valid graphs (`graph_mask`), and the
        aux metrics averaged the same way (plus "loss"). On the sparse path
        the aux also holds the cap's dropped edges per graph,
        "neighbor_overflow_mean" over the valid graphs and
        "neighbor_overflow_max", which the Trainer logs. Over a
        data-parallel `mesh` (`parallel/mesh.py`) the means and the max run
        over the valid graphs of every rank, and the loss returned is this
        rank's share of the global mean (its gradients summed over the
        ranks are the mean's)."""
        per_graph, aux, tel = self.noise_and_compute_loss(
            x, sigma, generator, self.config.align_noisy_input_during_training, True
        )
        group = mesh.group if mesh is not None else None
        if group is None:
            loss, aux = masked_graph_mean(per_graph, aux, x.graph_mask)
        else:
            loss, aux = global_graph_mean(per_graph, aux, x.graph_mask, mesh)
        ov = tel.get("neighbor_overflow")
        if ov is not None:
            ovf, gm = ov.to(loss.dtype), x.graph_mask
            sums = all_reduce_sum(torch.stack([(ovf * gm).sum(), gm.sum().to(loss.dtype)]), group)
            aux["neighbor_overflow_mean"] = sums[0] / torch.clamp(sums[1], min=1)
            aux["neighbor_overflow_max"] = all_reduce_max(
                torch.where(gm, ovf, torch.zeros_like(ovf)).max(), group
            )
        return loss, aux


@functools.lru_cache(maxsize=None)
def _fixed_noise(shape: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """`add_fixed_noise`'s draw (seed 0, the same for every graph), made once
    per (shape, device, dtype): a new host tensor copied to the card at every
    step would make the host wait there."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(device, dtype)


def masked_graph_mean(per_graph: torch.Tensor, aux: Dict[str, torch.Tensor], graph_mask):
    """(mean of per_graph over valid graphs, each aux metric likewise with
    "loss" added)."""
    gm = graph_mask.to(per_graph.dtype)
    denom = torch.clamp(gm.sum(), min=1.0)
    loss = (per_graph * gm).sum() / denom
    aux = {k: (v * gm).sum() / denom for k, v in aux.items()}
    aux["loss"] = loss
    return loss, aux
