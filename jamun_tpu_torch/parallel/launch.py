"""Start a process group on one machine and run work on every rank.

    results = spawn(run_plan, 2, (plan,), workdir=tmp, backend="gloo")

`spawn` starts `world` processes (the "spawn" start method), joins them to
one group (rendezvous through a file in `workdir`, no TCP port), runs
`fn(rank, world, *args)` in each and returns each rank's result. Every
rendezvous and collective has a `timeout` and the join a deadline: a rank
that hangs fails the call. Each process sees torchrun's variables (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `GROUP_RANK`), so
`parallel.distributed` behaves as under torchrun.

The workers below take a spec of host tensors and run one piece of the
port over the group: the sharded pair operation (`pair_op_worker`), the
atom-sharded forward (`forward_worker`),
`Trainer.fit` data parallel or atom sharded (`fit_worker`), `Sampler`
(`sample_worker`) and the train CLI (`train_cli_worker`); `run_plan` runs a
list of them in one group. The CPU tests (gloo) and `chip_smoke.py`
(gloo with CUDA tensors on one card, NCCL with one rank) use them.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from jamun_tpu_torch.utils.device import resolve_device

__all__ = [
    "spawn", "run_plan", "forward_worker", "pair_op_worker", "gaussian_pair_sum", "fit_worker",
    "sample_worker", "train_cli_worker",
    "to_host", "batch_from", "batch_spec",
]


def to_host(obj):
    """Tensors moved to the CPU (detached), through dicts, lists and tuples."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _worker(fn, rank: int, world: int, backend: str, init_method: str, args: tuple,
            out_dir: str, timeout: float, threads: Optional[int], cwds, env) -> None:
    os.environ.update(
        RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
        LOCAL_WORLD_SIZE=str(world), GROUP_RANK="0", **(env or {}),
    )
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    if cwds:
        os.chdir(cwds[rank])
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout),
        )
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(to_host(result), f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(
    fn: Callable, world: int, args: tuple = (), *, backend: str, workdir: str = ".",
    timeout: float = 120.0, threads: Optional[int] = None, cwds: Optional[Sequence[str]] = None,
    env: Optional[Dict[str, str]] = None,
) -> List[Any]:
    """Run `fn(rank, world, *args)` on `world` new processes joined in one
    group; returns the ranks' results in order (pickled through `workdir`,
    tensors on the CPU). `fn` must be importable (a module's top-level
    function). `backend` is named by the caller ("nccl" for one card a
    rank, "gloo" for the CPU or for several ranks on one card): nothing
    picks it. `timeout` (seconds) bounds the rendezvous, each collective
    and the whole run; `threads` sets each process's torch threads; `cwds`
    gives each rank its own working directory; `env` extra variables.
    Raises with the failing ranks' tracebacks, or when the deadline
    passes (the processes are killed)."""
    ctx = torch.multiprocessing.get_context("spawn")
    out_dir = os.path.abspath(workdir)
    os.makedirs(out_dir, exist_ok=True)
    init_method = "file://" + os.path.join(out_dir, f"rendezvous_{os.getpid()}_{time.time_ns()}")
    procs = [
        ctx.Process(target=_worker, args=(fn, r, world, backend, init_method, args, out_dir,
                                          timeout, threads, cwds, env), daemon=True)
        for r in range(world)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0 and r not in hung:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if hung or errors:
        raise RuntimeError(
            (f"ranks {hung} still running after {timeout} s\n" if hung else "") + "\n".join(errors)
        )
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def run_plan(rank: int, world: int, plan: Sequence[tuple]) -> list:
    """[(worker, spec), ...] run in order in one group; each worker's result."""
    return [worker(rank, world, spec) for worker, spec in plan]


# ---- the workers ----


def batch_spec(batch) -> dict:
    """A GraphBatch as a dict of host tensors (for a worker's spec)."""
    return {f.name: to_host(getattr(batch, f.name)) for f in dataclasses.fields(batch)}


def batch_from(spec: dict, device):
    from jamun_tpu_torch.ops.graph import GraphBatch

    return GraphBatch(**spec).to(device)


def _arch(spec: dict, device):
    """The E3Conv of a spec: its keyword arguments and state dict."""
    from jamun_tpu_torch.models.e3conv import E3Conv

    arch = E3Conv(**spec["arch"], device=device)
    arch.load_state_dict(spec["state"], strict=True)
    return arch


def _denoiser(spec: dict, device):
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig

    return Denoiser(_arch(spec, device), DenoiserConfig(**spec["config"]))


def _device(spec: dict):
    """spec["device"] by `resolve_device`: the rank's card unless it names another device."""
    return resolve_device(spec.get("device"))


def _kernels() -> dict:
    """Every hand-written kernel's wrapper state (`ops/cuda`), by name."""
    from jamun_tpu_torch.ops.cuda import (
        conv_block, conv_block_bwd, dense_conv, e3_stack, edge_features, fused_block_tiled,
        kabsch, nbr_conv, nbr_edge_features,
    )

    return {k.name: k for k in (
        edge_features.KERNEL, conv_block.KERNEL, conv_block.LAYER_KERNEL, e3_stack.KERNEL,
        conv_block_bwd.KERNEL, fused_block_tiled.KERNEL, nbr_conv.KERNEL, nbr_edge_features.KERNEL,
        dense_conv.K8, dense_conv.K9, kabsch.KERNEL,
    )}


def _launches(counters: Optional[Sequence[str]]) -> Dict[str, int]:
    """The launch counts of the named kernels."""
    kernels = _kernels() if counters else {}
    return {name: kernels[name].launches for name in counters or ()}


def _zero_launches(counters: Optional[Sequence[str]]) -> None:
    kernels = _kernels() if counters else {}
    for name in counters or ():
        kernels[name].launches = 0


def _timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def forward_worker(rank: int, world: int, spec: dict) -> dict:
    """The atom-sharded E3Conv forward (`atom_sharded_arch_apply`) on
    spec["batch"], and with spec["grads"] the gradients of sum(out^2) summed
    over the ranks. Returns {"out", "grads", "seconds"}."""
    from jamun_tpu_torch.parallel.atom_sharded import atom_sharded_arch_apply
    from jamun_tpu_torch.parallel.mesh import all_reduce_grads, make_mesh

    device = _device(spec)
    mesh = make_mesh(world)
    arch = _arch(spec, device)
    batch = batch_from(spec["batch"], device)
    c_noise = torch.tensor([spec["c_noise"]], dtype=torch.float32, device=device)
    want_grads = spec.get("grads", False)
    arch.requires_grad_(want_grads)
    with torch.set_grad_enabled(want_grads):
        out, seconds = _timed(
            lambda: atom_sharded_arch_apply(arch, mesh, batch, c_noise, spec["cutoff"]), device
        )
    result = {"out": out, "seconds": seconds}
    if want_grads:
        (out.to(torch.float32) ** 2).sum().backward()
        params = list(arch.parameters())
        all_reduce_grads(params, mesh)
        result["grads"] = {n: p.grad for n, p in arch.named_parameters()}
    return result


def gaussian_pair_sum(x_full, pos_full, dst_start: int, n_local: int):
    """A dense pair operation for `atom_sharded_pair_op`: the rows
    [dst_start, dst_start + n_local) of exp(-|p_i - p_j|^2) @ x."""
    pos_dst = pos_full[dst_start:dst_start + n_local]
    d2 = ((pos_dst[:, None, :] - pos_full[None, :, :]) ** 2).sum(-1)
    return torch.exp(-d2) @ x_full


def pair_op_worker(rank: int, world: int, spec: dict) -> dict:
    """`atom_sharded_pair_op(mesh, gaussian_pair_sum)` on this rank's rows of
    spec["x"] [N, D] and spec["pos"] [N, 3]: every rank's output rows, and
    the gradients of sum(out^2) for x and pos, gathered."""
    from jamun_tpu_torch.parallel.atom_sharded import atom_sharded_pair_op, shard_atoms
    from jamun_tpu_torch.parallel.mesh import all_gather, make_mesh

    mesh = make_mesh(world)
    x = shard_atoms(spec["x"], mesh).clone().requires_grad_(True)
    pos = shard_atoms(spec["pos"], mesh).clone().requires_grad_(True)
    out = atom_sharded_pair_op(mesh, gaussian_pair_sum)(x, pos)
    (out ** 2).sum().backward()
    return {k: all_gather(v.detach(), mesh.group, 0) for k, v in
            (("out", out), ("x_grad", x.grad), ("pos_grad", pos.grad))}


def fit_worker(rank: int, world: int, spec: dict) -> dict:
    """`Trainer.fit` over the group on spec["train"] (global batches), with
    spec["trainer"] as TrainerConfig fields (`atom_sharded`, ...),
    spec["optimizer"] = (name of a `train/optim.py` factory, kwargs) and
    ConstantSigma(spec["sigma"]). Returns the trained parameters, the logged
    metrics, the last step's gradients (summed over the ranks), the
    launches of spec["counters"] and the seconds of the fit."""
    import tempfile

    from jamun_tpu_torch.train import optim
    from jamun_tpu_torch.train.distributions import ConstantSigma
    from jamun_tpu_torch.train.loop import Trainer, TrainerConfig
    from jamun_tpu_torch.utils.testing import FixedBatches, RecordingLogger

    device = _device(spec)
    den = _denoiser(spec, device)
    train = [batch_from(b, "cpu") for b in spec["train"]]
    val = [batch_from(b, "cpu") for b in spec.get("val", ())]
    name, kwargs = spec["optimizer"]
    rec = RecordingLogger()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainerConfig(
            seed=0, checkpoint_dir=os.path.join(tmp, "checkpoints"), num_devices=world,
            **spec["trainer"],
        )
        _zero_launches(spec.get("counters"))
        state, seconds = _timed(lambda: Trainer(cfg, rec, device=device).fit(
            den, getattr(optim, name)(**kwargs), ConstantSigma(spec["sigma"]),
            FixedBatches(train, val),
        ), device)
        launches = _launches(spec.get("counters"))
    return {
        "params": {n: p.detach() for n, p in state.module.named_parameters()},
        "ema": {n: p.detach() for n, p in state.ema.named_parameters()},
        "grads": {n: p.grad for n, p in state.module.named_parameters()},
        "metrics": rec.metrics, "launches": launches, "seconds": seconds, "steps": state.step,
    }


def sample_worker(rank: int, world: int, spec: dict) -> dict:
    """`Sampler(num_devices=world)` (chains split) or
    `Sampler(atom_sharded=True)` (spec["atom_sharded"]) on spec["batch"],
    BAOAB with spec["mcmc"] (MCMCConfig fields) at spec["sigma"]. Returns
    the per-graph samples of every batch, the launches of spec["counters"],
    the seconds of the sampling and, on rank 0 (which runs the callbacks),
    each batch's seconds."""
    from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
    from jamun_tpu_torch.sampling.sampler import Sampler
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler

    device = _device(spec)
    den = _denoiser(spec, device)
    den.arch.requires_grad_(False)
    bs = SingleMeasurementSampler(mcmc=BAOAB(MCMCConfig(**spec["mcmc"])), sigma=spec["sigma"])
    atom = spec.get("atom_sharded", False)
    batch_seconds = []

    class Times:
        def on_after_sample_batch(self, elapsed_seconds, **kwargs):
            batch_seconds.append(elapsed_seconds)

    sampler = Sampler(callbacks=[Times()], num_devices=world, atom_sharded=atom, device=device)
    _zero_launches(spec.get("counters"))
    samples, seconds = _timed(lambda: sampler.sample(
        den, bs, spec.get("num_batches", 1), batch_from(spec["batch"], device),
        continue_chain=True, seed=spec.get("seed", 0),
    ), device)
    return {"samples": samples, "launches": _launches(spec.get("counters")), "seconds": seconds,
            "batch_seconds": batch_seconds}


def train_cli_worker(rank: int, world: int, argv: List[str]) -> dict:
    """`python -m jamun_tpu_torch.cmdline.train <argv>` in this rank's
    working directory; returns the final step and the files written under
    `runs/` there."""
    from jamun_tpu_torch.cmdline import train

    state = train.main(list(argv))
    written = sorted(
        os.path.relpath(os.path.join(d, f), ".") for d, _, fs in os.walk("runs") for f in fs
    )
    return {"step": state.step, "files": written}
