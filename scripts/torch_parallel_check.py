"""Data parallel and atom sharding of the port over the cards of one machine
(`jamun_tpu_torch/parallel/`: NCCL, one rank per card), each against the
single process on the first card, and the train CLI under torchrun.

    python3 scripts/torch_parallel_check.py --ranks 4 [--out FILE]
    python3 scripts/torch_parallel_check.py --ranks 4 --cpu   # gloo on the CPU, narrow widths

Checks, at the flagship's widths on the card: `Trainer.fit` data parallel
(f32, G = 32 split over the ranks, 5 SGD steps: losses and parameters
against the single process, 1e-5); atom sharded (f32, one chain of 2048
atoms split over the ranks, 2 steps: losses 1e-5, the last step's
gradients 1e-4 of each leaf's max); `Sampler(num_devices=<ranks>)` (bf16,
4AA, G = 256, 2 x 101 steps on K3: the trajectories' differing bits, 1e-4);
`torchrun --standalone --nproc_per_node=<ranks> -m
jamun_tpu_torch.cmdline.train experiment=train_uncapped_4AA
model/arch=e3conv_separable parallel.num_devices=<ranks>` (5 steps, rank 0
writes the run directory). Times are of the second step or batch. Prints
one JSON object per check and the cards' names and power limits; exits
non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from jamun_tpu_torch.parallel import launch  # noqa: E402
from jamun_tpu_torch.utils.testing import make_test_batch  # noqa: E402


def check(name: str, ok: bool, **numbers) -> bool:
    print(json.dumps(dict(check=name, ok=ok, **numbers), default=str), flush=True)
    return ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU, narrow widths")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    world = args.ranks
    if args.cpu:
        device, backend, G, N, atoms, walk_g = "cpu", "gloo", 4 * world, 12, 16 * world, 2 * world
        cs.P12_ARCH.update(irreps_hidden="16x0e + 8x1e", n_layers=2)
    else:
        if torch.cuda.device_count() < world:
            print(f"needs {world} cards, found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device, backend, G, N, atoms, walk_g = "cuda", "nccl", 32, 48, 2048, 256
        from jamun_tpu_torch.ops.cuda.build import build_all

        build_all()  # once, before any rank loads a kernel
        for line in subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True,
        ).stdout.strip().splitlines():
            print(line, flush=True)
    results, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        def ranks(fn, spec):
            return launch.spawn(fn, world, (spec,), workdir=tempfile.mkdtemp(dir=tmp),
                                backend=backend, timeout=900)

        # data parallel, f32 SGD: the ranks against the single process
        train = [make_test_batch(num_graphs=G, max_nodes=N, nodes_per_graph=[N - 4] * G,
                                 max_bonds=2 * N, seed=s, device="cpu") for s in range(5)]
        fit = cs.p12_fit_spec(cs.p12_spec(device=device), train,
                              ("sgd", dict(learning_rate=5e-2, momentum=0.9, nesterov=True)))
        fit["counters"] = ()
        alone = launch.fit_worker(0, 1, fit)
        got = ranks(launch.fit_worker, fit)
        step_err = max(abs(a - b) / abs(b) for x, y in zip(
            cs.p12_logged(got[0]["metrics"]), cs.p12_logged(alone["metrics"])) for a, b in zip(x, y))
        param_err = cs.p12_rel(got[0]["params"], {k: v.cpu() for k, v in alone["params"].items()})
        equal = all(torch.equal(r["params"][k], got[0]["params"][k]) for r in got for k in r["params"])
        results["data_parallel"] = dict(
            G=G, N=N, ranks=world, step_rel_err=step_err, param_rel_err=param_err, ranks_equal=equal,
            ms_per_step=cs.p12_ms_per_step(got[0]["metrics"]),
            ms_per_step_alone=cs.p12_ms_per_step(alone["metrics"]))
        ok &= check("data_parallel", step_err <= 1e-5 and param_err <= 1e-5 and equal,
                    **results["data_parallel"])

        # atom sharded, f32: one chain over the ranks
        spec = cs.p12_spec(gain=1.0, device=device, **({"neighbor_mode": "nbr"} if args.cpu else {}))
        step = cs.p12_fit_spec(spec, [cs.chain_batch(atoms, 1, "cpu")], ("sgd", dict(learning_rate=1e-3)),
                               True, steps=2)
        step["counters"] = ()
        alone = launch.fit_worker(0, 1, dict(step, trainer=dict(step["trainer"], atom_sharded=False)))
        got = ranks(launch.fit_worker, step)
        loss_err = max(abs(a - b) / abs(b) for x, y in zip(
            cs.p12_logged(got[0]["metrics"]), cs.p12_logged(alone["metrics"])) for a, b in zip(x, y))
        grad_err = cs.p12_rel(got[0]["grads"], {k: v.cpu() for k, v in alone["grads"].items()})
        results["atom_sharded"] = dict(
            atoms=atoms, ranks=world, rows_per_rank=atoms // world, step_rel_err=loss_err,
            grad_rel_err=grad_err, ms_second_step=cs.p12_ms_per_step(got[0]["metrics"]),
            ms_second_step_alone=cs.p12_ms_per_step(alone["metrics"]))
        ok &= check("atom_sharded", loss_err <= 1e-5 and grad_err <= 1e-4, **results["atom_sharded"])

        # the chains of the stack walk over the ranks
        walk = dict(cs.p12_spec("bfloat16", gain=1.0, device=device, fused_stack=True),
                    batch=launch.batch_spec(make_test_batch(
                        num_graphs=walk_g, max_nodes=44, nodes_per_graph=[44] * walk_g,
                        max_bonds=88, scale=0.35, device="cpu")),
                    sigma=cs.SIGMA, num_batches=2, mcmc=dict(cs.P12_WALK, steps=101))
        alone = launch.sample_worker(0, 1, walk)
        got = ranks(launch.sample_worker, walk)
        errs = cs.p12_samples_err(got[0]["samples"], alone["samples"])
        results["sampler"] = dict(
            G=walk_g, ranks=world, err=errs,
            ms_per_step_batch_2=got[0]["batch_seconds"][1] * 1e3 / 101,
            ms_per_step_batch_2_alone=alone["batch_seconds"][1] * 1e3 / 101)
        ok &= check("sampler", all(e["max_rel_err"] <= 1e-4 for e in errs.values()), **results["sampler"])

        # the train CLI under torchrun
        work = tempfile.mkdtemp(dir=tmp)
        data = os.path.join(work, "data")
        cs.write_4aa_dataset(data)
        cli = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={world}", "-m", "jamun_tpu_torch.cmdline.train",
               "--experiment-dir", os.path.join(ROOT, "configs", "experiment"),
               "experiment=train_uncapped_4AA", "model/arch=e3conv_separable", "run_key=torchrun",
               "trainer.max_steps=5", "trainer.val_every_n_steps=5", "trainer.log_every_n_steps=1",
               "trainer.val_max_batches=1", f"parallel.num_devices={world}"]
        if args.cpu:
            cli += ["device=cpu", "model.arch.irreps_hidden=16x0e + 8x1e", "model.arch.n_layers=2"]
        env = dict(os.environ, JAMUN_DATA_PATH=data, PYTHONPATH=ROOT)
        run = subprocess.run(cli, cwd=work, env=env, capture_output=True, text=True, timeout=900)
        run_dir = os.path.join(work, "runs", "torchrun")
        train_rows, _ = cs.read_metrics_csv(os.path.join(run_dir, "metrics.csv")) if run.returncode == 0 else ([], [])
        results["torchrun_cli"] = dict(
            rc=run.returncode, steps=len(train_rows), losses=[r["train/loss"] for r in train_rows],
            last_ckpt=os.path.exists(os.path.join(run_dir, "checkpoints", "last.ckpt")),
            stderr_tail=run.stderr[-2000:] if run.returncode else "")
        ok &= check("torchrun_cli", run.returncode == 0 and len(train_rows) == 5
                    and results["torchrun_cli"]["last_ckpt"], **results["torchrun_cli"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
