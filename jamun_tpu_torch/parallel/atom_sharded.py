"""Atom-sharded message passing for very large single molecules
(counterpart of `jamun_tpu/parallel/atom_sharded.py`).

The atoms of each molecule are split over the ranks along the destination
axis. Every rank holds the whole batch (replicated): the Denoiser's
preconditioning, mean-centring, Kabsch alignment, loss and walk run the same
on each. Only the arch forward is sharded: each rank runs `E3Conv` on its
contiguous slice of destination rows (`E3Conv(atom_axis=...)`), which
all-gathers the positions once per forward and every `Conv` its source
features once per layer (the halo, `parallel.mesh.gather_halo`: backward a
reduce-scatter), and the output rows are all-gathered back
(`gather_replicated`: the cotangent is the same on every rank, so the
backward keeps this rank's slice). Parameter gradients are then partial on
each rank and are summed over the ranks (`parallel.mesh.all_reduce_grads`).

The sharded forward runs the plain path, as JAX's does (its
`atom_sharded_forward` sets `use_pallas=False`): no kernel under an atom
axis. It needs a flat-atom arch: the residue fields are dropped, and an
arch without `sharded_forward` (Ophiuchus, which pools atoms into
residues) raises. A mesh of one process (no group) runs the same plain
path with no collective, as JAX's one-device mesh does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from jamun_tpu_torch.ops.graph import GraphBatch
from jamun_tpu_torch.parallel.mesh import Mesh, gather_halo, gather_replicated

__all__ = [
    "atom_sharded_pair_op",
    "shard_atoms",
    "atom_sharded_arch_apply",
    "prepare_atom_sharded_batch",
    "atom_sharded_forward",
    "pad_atoms_to_multiple",
    "AtomShardedArch",
    "denoiser_with_atom_sharding",
    "resolve_atom_sharded",
    "partition_bonds_by_dst",
]

_ATOM_FIELDS = (
    "pos", "node_mask", "atom_type_index", "atom_code_index", "residue_code_index",
    "residue_sequence_index",
)
_BOND_FIELDS = ("bond_src", "bond_dst", "bond_mask")
_RESIDUE_FIELDS = dict(
    residue_atom_index=None, residue_atom_mask=None, residue_ca_index=None, residue_mask=None,
    residue_codes=None,
)


def _check_arch(arch) -> None:
    if not hasattr(arch, "sharded_forward"):
        raise ValueError(
            f"{type(arch).__name__} has no atom axis: atom sharding needs a flat-atom arch "
            "(E3Conv); Ophiuchus pools atoms into residues"
        )


def _local_slice(n: int, mesh: Mesh):
    if n % mesh.size:
        raise ValueError(f"pad atoms to a multiple of {mesh.size} first (N={n})")
    n_loc = n // mesh.size
    return mesh.rank * n_loc, n_loc


def shard_atoms(arr: torch.Tensor, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of the atom axis of `arr`."""
    start, n_loc = _local_slice(arr.shape[axis], mesh)
    return arr.narrow(axis, start, n_loc)


def atom_sharded_pair_op(mesh: Mesh, pair_fn: Callable):
    """A dense pair operation for one large molecule, sharded over the ranks.

    pair_fn(x_full [N, D], pos_full [N, 3], dst_start, n_local) ->
    [n_local, D_out] computes a contiguous slice of destination rows from the
    whole (gathered) features and positions. The returned function takes
    this rank's rows (x_local, pos_local), all-gathers both (the halo) and
    returns this rank's output rows; it is differentiable."""

    def sharded(x_local: torch.Tensor, pos_local: torch.Tensor) -> torch.Tensor:
        x_full = gather_halo(x_local, mesh.group, 0)
        pos_full = gather_halo(pos_local, mesh.group, 0)
        n_local = x_local.shape[0]
        return pair_fn(x_full, pos_full, mesh.rank * n_local, n_local)

    return sharded


def partition_bonds_by_dst(bond_src, bond_dst, bond_mask, n_dev: int, n_loc: int):
    """Repartition per-graph bond lists so that each rank owns the bonds
    whose destination atom it holds (dst re-indexed to local rows; src stays
    global: it indexes the gathered halo). Returns numpy [G, n_dev * B_loc]
    arrays laid out rank-major."""
    to_np = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)  # noqa: E731
    bond_src, bond_dst = to_np(bond_src), to_np(bond_dst)
    bond_mask = to_np(bond_mask).astype(bool)
    G = bond_src.shape[0]
    per_dev = [[[] for _ in range(n_dev)] for _ in range(G)]
    for g in range(G):
        for b in range(bond_src.shape[1]):
            if not bond_mask[g, b]:
                continue
            d = int(bond_dst[g, b]) // n_loc
            per_dev[g][d].append((int(bond_src[g, b]), int(bond_dst[g, b]) - d * n_loc))
    B_loc = max(1, max(len(per_dev[g][d]) for g in range(G) for d in range(n_dev)))
    src = np.zeros((G, n_dev * B_loc), np.int32)
    dst = np.zeros((G, n_dev * B_loc), np.int32)
    msk = np.zeros((G, n_dev * B_loc), bool)
    for g in range(G):
        for d in range(n_dev):
            for i, (s, t) in enumerate(per_dev[g][d]):
                src[g, d * B_loc + i] = s
                dst[g, d * B_loc + i] = t
                msk[g, d * B_loc + i] = True
    return src, dst, msk


def prepare_atom_sharded_batch(batch: GraphBatch, mesh: Mesh) -> GraphBatch:
    """Host-side batch preparation for the atom-sharded forward, once per
    batch: bonds repartitioned by the rank of their destination atom, the
    residue fields dropped. The batch stays whole on every rank."""
    N = batch.pos.shape[1]
    _, n_loc = _local_slice(N, mesh)
    bsrc, bdst, bmask = partition_bonds_by_dst(
        batch.bond_src, batch.bond_dst, batch.bond_mask, mesh.size, n_loc
    )
    dev = batch.bond_src.device
    return dataclasses.replace(
        batch,
        bond_src=torch.as_tensor(bsrc, dtype=batch.bond_src.dtype, device=dev),
        bond_dst=torch.as_tensor(bdst, dtype=batch.bond_dst.dtype, device=dev),
        bond_mask=torch.as_tensor(bmask, device=dev),
        **_RESIDUE_FIELDS,
    )


def _local_atoms(batch: GraphBatch, mesh: Mesh) -> GraphBatch:
    """This rank's destination rows and bond block of a prepared batch."""
    start, n_loc = _local_slice(batch.pos.shape[1], mesh)
    bstart, b_loc = _local_slice(batch.bond_src.shape[1], mesh)
    rows = {f: getattr(batch, f).narrow(1, start, n_loc) for f in _ATOM_FIELDS}
    rows.update({f: getattr(batch, f).narrow(1, bstart, b_loc) for f in _BOND_FIELDS})
    return dataclasses.replace(batch, **rows, **_RESIDUE_FIELDS)


def atom_sharded_forward(arch, mesh: Mesh, sharded: GraphBatch, c_noise, cutoff) -> torch.Tensor:
    """The arch forward on a batch prepared by `prepare_atom_sharded_batch`:
    this rank's destination rows through `arch.sharded_forward` over the
    mesh's group (its parameters, the plain path), then every rank's rows
    gathered. Returns the whole [G, N, out] on every rank. A mesh of one
    process (no group) runs the same plain path with no collective, as
    JAX's one-device mesh does."""
    _check_arch(arch)
    out, _ = arch.sharded_forward(_local_atoms(sharded, mesh), c_noise, cutoff, mesh.group)
    return gather_replicated(out, mesh.group, 1)


def atom_sharded_arch_apply(arch, mesh: Mesh, batch: GraphBatch, c_noise, cutoff):
    """The arch forward with the atoms of each molecule sharded over the
    ranks: `prepare_atom_sharded_batch` then `atom_sharded_forward`. Equals
    the single-process forward (tests/test_torch_parallel.py)."""
    return atom_sharded_forward(arch, mesh, prepare_atom_sharded_batch(batch, mesh), c_noise, cutoff)


def pad_atoms_to_multiple(batch: GraphBatch, multiple: int) -> GraphBatch:
    """Pad the atom axis of every [G, N, ...] field with masked rows (zeros)
    to a multiple of `multiple`. Bond lists index the original rows and stay;
    the residue fields are dropped."""
    N = batch.pos.shape[1]
    pad = (-N) % multiple
    if pad == 0:
        return batch

    def pad_atom_axis(x):
        if x.ndim < 2 or x.shape[1] != N:
            return x
        return torch.cat([x, x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))], dim=1)

    rows = {f: pad_atom_axis(getattr(batch, f)) for f in _ATOM_FIELDS}
    return dataclasses.replace(batch, **rows, **_RESIDUE_FIELDS)


class AtomShardedArch(nn.Module):
    """An arch whose forward is atom-sharded over `mesh`: the Denoiser, the
    train step (gradients through the halo gathers), the walk and the
    sampler run it unchanged on molecules whose pair work one card should
    not hold. Batches are prepared with `pad_atoms_to_multiple` and
    `prepare_atom_sharded_batch` first. Its parameters are the wrapped
    arch's. Telemetry is empty: atom-sharded runs report no
    `neighbor_overflow`, as in JAX; it takes no Verlet list."""

    def __init__(self, arch, mesh: Mesh):
        super().__init__()
        _check_arch(arch)
        self.arch = arch
        self.mesh = mesh

    @property
    def neighbor_mode(self):
        return getattr(self.arch, "neighbor_mode", None)

    @property
    def neighbor_cap(self):
        return getattr(self.arch, "neighbor_cap", 32)

    def forward(self, batch: GraphBatch, c_noise, radial_cutoff, with_telemetry: bool = False):
        out = atom_sharded_forward(self.arch, self.mesh, batch, c_noise, radial_cutoff)
        return (out, {}) if with_telemetry else out


def denoiser_with_atom_sharding(denoiser, mesh: Mesh):
    """A copy of `denoiser` whose arch forward is atom-sharded over `mesh`."""
    from jamun_tpu_torch.models.denoiser import Denoiser

    return Denoiser(AtomShardedArch(denoiser.arch, mesh), denoiser.config)


def resolve_atom_sharded(mode, n_atoms: int, threshold: int, n_devices: int) -> bool:
    """The `parallel.atom_sharded` setting: False | True | "auto" (on from
    `threshold` padded atoms on); off on one device."""
    if n_devices <= 1 or mode in (False, None, "false", "off"):
        return False
    if mode in (True, "true", "on"):
        return True
    if mode == "auto":
        return n_atoms >= threshold
    raise ValueError(f"parallel.atom_sharded={mode!r} (want true/false/auto)")
