"""The train traffic: the train CLI's step, `Trainer.fit`.

One `Trainer.fit` call (max_epochs 1, no validation batches, the CLI's
logging every `log_every_n_steps`, adam with the configuration's learning
rate, a constant sigma, checkpoints, diagnostics and the metrics CSV under
the run's temporary directory) trains the model from the seed. Its data
module cycles a pool of `pool_batches` seeded, collated, page-locked host
batches, and goes on from one `fit` call to the next. The first
`check_steps` steps are the set-up's. The window starts when the data
module hands out the next batch (after a synchronisation) and ends at
`fit`'s return and a synchronisation; the data module stops at the deadline.

The trainer's state is the one object `fit` builds; the driver keeps a
reference to it (through `create_train_state`). The reference follows two
stretches of it: the set-up's steps from the seed, and `check_steps` steps
after the window, which a second `fit` of the same state and data module
takes once the window has closed, from a copy of the state on the host
(parameters, Adam's moments and count, the EMA). A `--trace 1` run profiles
`trace_steps` more steps of the same state after that.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import torch

from benchmark.costs import e3conv as costs
from benchmark.inputs.batches import train_pool
from benchmark.reference import train as rt
from benchmark.reference.denoiser import factors, mean_center

__all__ = ["Driver"]


class _Quiet:
    def log_metrics(self, metrics, step):
        pass

    def finalize(self):
        pass


class _Batches:
    """`fit`'s data module: the pool in order, round and round, going on
    from one `fit` call to the next. `on_next(k)`, k the batches this call
    has handed out, is asked before each batch; the call's batches stop when
    it returns False."""

    streaming = False

    def __init__(self, pool):
        self.pool, self.on_next, self.served = pool, None, 0

    def train_batches(self, epoch: int = 0):
        k = 0
        while self.on_next(k):
            i, self.served, k = self.served, self.served + 1, k + 1
            yield self.pool[i % len(self.pool)]

    def val_batches(self):
        return iter(())


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


class Driver:
    kind = "train"

    def __init__(self, cell):
        self.cell = cell
        self.mix = cell.mix
        self.sigma = float(self.mix["sigma"])
        self.optim = dict(b1=0.9, b2=0.999, eps=1e-8, learning_rate=float(cell.config["optim"]["learning_rate"]))
        self._refs = {}

    @contextlib.contextmanager
    def _spy(self):
        """Keep the state that `fit` builds (the first time; later calls of
        `fit` continue it) and each step's loss while `self.losses` is a list."""
        from jamun_tpu_torch.train import loop

        made, orig_state, orig_step = self.__dict__, loop.create_train_state, loop.make_train_step

        def create(*args, **kwargs):
            if "state" not in made:
                made["state"] = orig_state(*args, **kwargs)
            return made["state"]

        def make_step(*args, **kwargs):
            step = orig_step(*args, **kwargs)

            def run(state, batch):
                state, aux = step(state, batch)
                if self.losses is not None:
                    self.losses.append(aux["loss"].detach().clone())
                return state, aux

            return run

        loop.create_train_state, loop.make_train_step = create, make_step
        try:
            yield
        finally:
            loop.create_train_state, loop.make_train_step = orig_state, orig_step

    def _fit(self, on_next) -> None:
        self.feed.on_next = on_next
        with self._spy():
            self.trainer.fit(self.denoiser, self.optimizer, self.sigma_dist, self.feed)

    # ---- set-up ----

    def setup(self) -> None:
        from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
        from jamun_tpu_torch.models.e3conv import E3Conv
        from jamun_tpu_torch.ops.graph import GraphBatch
        from jamun_tpu_torch.train.distributions import ConstantSigma
        from jamun_tpu_torch.train.loggers import CSVLogger, MultiLogger
        from jamun_tpu_torch.train.loop import Trainer, TrainerConfig
        from jamun_tpu_torch.train.optim import adam

        cell, dev = self.cell, self.cell.device
        arch = dict(cell.config["arch"])
        arch.pop("_target_", None)
        self.inputs()
        net = E3Conv(**arch, device=dev)
        net.load_state_dict(self.weights, strict=True)
        self.denoiser = Denoiser(net, DenoiserConfig(**cell.config["denoiser"]))
        pin = dev.type == "cuda"
        self.feed = _Batches([
            GraphBatch(**{k: (torch.as_tensor(v).pin_memory() if pin else torch.as_tensor(v)) for k, v in b.items()})
            for b in self.pool_np
        ])
        run_dir = os.path.join(cell.tmpdir, "bench_train")
        os.makedirs(run_dir, exist_ok=True)
        tconf = TrainerConfig(
            max_epochs=1, log_every_n_steps=int(self.mix["log_every_n_steps"]),
            checkpoint_dir=os.path.join(run_dir, "checkpoints"), ema_decay=float(self.mix["ema_decay"]),
            seed=self.trainer_seed,
        )
        loggers = MultiLogger(CSVLogger(run_dir)) if dev.type == "cuda" else _Quiet()
        self.trainer = Trainer(tconf, loggers, device=dev)
        self.optimizer = adam(self.optim["learning_rate"])
        self.sigma_dist = ConstantSigma(self.sigma)
        self.losses, self.window_steps, self.deadline = [], None, None

    def inputs(self) -> None:
        """What the program and the reference are both handed, from the seed:
        the weights, the pool of batches and the trainer's seed."""
        cell = self.cell
        self.weights = cell.make_weights()
        self.pool_np = train_pool(cell.seed, self.mix)
        self.trainer_seed = int(cell.seed) * 1000 + 7
        self.ema_decay = float(self.mix["ema_decay"])
        self.steps_before = int(self.mix["check_steps"])

    # ---- the window (one `fit` from the seed: the set-up's steps, then the window) ----

    def _snapshot(self, k: int) -> bool:
        state = self.__dict__.get("state")
        n = self.steps_before
        if k == 1:
            b1 = self.optim["b1"]
            opt = state.optimizer
            self.program = {"grad1": {name: opt.state[p].get("mu", torch.zeros_like(p)).detach() / (1 - b1)
                                      for name, p in state.module.named_parameters()}}
        if k == n:
            self.program["change"] = {name: p.detach() - self.weights[name]
                                      for name, p in state.module.named_parameters()}
            self.program["ema_change"] = {name: p.detach() - self.weights[name]
                                          for name, p in state.ema.named_parameters()}
            self.program["losses"] = [float(t) for t in self.losses]
            self.losses = None
            self._sync()
            self.on_window_start()
            self.t0 = time.perf_counter()
            self.deadline = self.t0 + self.seconds
        if k > n:
            return time.perf_counter() < self.deadline
        return True

    def _sync(self):
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def run(self, seconds: float, on_window_start, keep_frames: bool = False) -> Dict[str, float]:
        """The set-up's steps and the window in one `fit`, then the steps
        after it that the reference follows. `on_window_start` is called
        once the set-up's steps are done (the harness takes the set-up time
        there)."""
        self.seconds, self.on_window_start = seconds, on_window_start
        self._fit(self._snapshot)
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.window_steps = self.state.step - self.steps_before
        self.finite = all(bool(torch.isfinite(p).all()) for p in self.state.module.parameters())
        self._steps_after()
        return {"train_ms_per_step": 1e3 * self.window_s / self.window_steps}

    def _steps_after(self) -> None:
        """Once the window has closed: the state copied to the host, then
        `check_steps` more steps through the same `fit` and data module, and
        the program's readings of them."""
        state, b1 = self.state, self.optim["b1"]
        opt, names = state.optimizer, [name for name, _ in state.module.named_parameters()]

        def leaves(module):
            return {name: _host(p) for name, p in module.named_parameters()}

        def moment(key):  # zeros where the optimizer holds none (a step left out)
            return {name: _host(opt.state[p].get(key, torch.zeros_like(p)))
                    for name, p in zip(names, state.module.parameters())}

        self.after = {"params": leaves(state.module), "ema": leaves(state.ema), "mu": moment("mu"),
                      "nu": moment("nu"), "count": int(opt.param_groups[0]["count"]), "first": self.feed.served}
        seen = {}

        def on_next(k):
            if k == 1:
                seen["mu"] = moment("mu")
            return k < self.steps_before

        self.losses = []
        self._fit(on_next)
        mu0 = self.after["mu"]
        self.program_after = {
            "losses": [float(t) for t in self.losses],
            "grad1": {k: (v.double() - b1 * mu0[k].double()) / (1 - b1) for k, v in seen["mu"].items()},
            "change": {k: v - self.after["params"][k] for k, v in leaves(state.module).items()},
            "ema_change": {k: v - self.after["ema"][k] for k, v in leaves(state.ema).items()},
        }
        self.losses = None

    def attempted(self) -> int:
        """Optimisation steps in the window."""
        return self.window_steps

    def failed(self) -> int:
        """All of them where the parameters came out of the window not finite."""
        return 0 if self.finite else self.window_steps

    # ---- what the per-layer metrics read ----

    def _pairs(self, steps: range) -> List[int]:
        """Visited pairs of the noisy batch of each step (its noise drawn
        again from the trainer's seed: distances do not change under the
        Kabsch alignment)."""
        dev = self.cell.device
        den = self.cell.config["denoiser"]
        c_in = factors(self.sigma, den["average_squared_distance"])[0]
        cutoff = (den["max_radius"] ** 2 + 6 * self.sigma**2) ** 0.5 / c_in
        shape = self.pool_np[0]["pos"].shape
        noise = rt.noise_draws(self.trainer_seed, shape, steps.stop, dev)
        out = []
        for s in steps:
            b = self.pool_np[s % len(self.pool_np)]
            mask = torch.as_tensor(b["node_mask"], device=dev)
            x = mean_center(torch.as_tensor(b["pos"], device=dev), mask)
            y = mean_center(x + self.sigma * noise[s] * mask[..., None], mask)
            out.append(int(costs.visited_pairs(y * c_in, mask, torch.as_tensor(b["bond_mask"], device=dev),
                                               cutoff).sum()))
        return out

    def _flops(self, steps: range) -> int:
        arch = self.cell.config["arch"]
        S, V = (int(t.strip().split("x")[0]) for t in arch["irreps_hidden"].split("+"))
        S_emb = sum(arch[k] for k in ("atom_type_embedding_dim", "atom_code_embedding_dim",
                                      "residue_code_embedding_dim", "residue_index_embedding_dim"))
        total = 0
        for s, p in zip(steps, self._pairs(steps)):
            nodes = int(self.pool_np[s % len(self.pool_np)]["node_mask"].sum())
            total += 3 * costs.uvw_forward_flops(p, nodes, S, V, S_emb, int(arch["n_layers"]))
        return total

    def readings(self, profile_slice) -> dict:
        n0 = self.steps_before
        flops = self._flops(range(n0, n0 + self.window_steps))
        steps = int(self.mix["trace_steps"])
        done = self.state.step
        prof = profile_slice(lambda: self._fit(lambda k: k < steps), steps=steps)
        assert self.state.step == done + steps
        return dict(kind="train", slice=prof, window_s=self.window_s, window_flops=flops,
                    peak_flops=costs.peaks()["f32_flops"])

    # ---- the check ----

    def release(self) -> None:
        del self.state, self.trainer, self.denoiser

    def _reference(self, prec, keep: float = 1.0, after: bool = False) -> dict:
        """The reference's steps: the set-up's from the seed's weights, or
        with `after` those after the window from the program's state."""
        from benchmark.reference.model import E3Conv as RefNet

        dev = self.cell.device
        net = RefNet(self.cell.config["arch"], prec).to(dev)
        n, state = self.steps_before, None
        if after:
            first = self.after["first"]
            net.load_state_dict(self.after["params"], strict=True)
            state = {k: {name: v.to(dev) for name, v in self.after[k].items()} for k in ("mu", "nu", "ema")}
            state["count"] = self.after["count"]
        else:
            first = 0
            net.load_state_dict(self.weights, strict=True)
        pool = self.pool_np
        batches = [{k: torch.as_tensor(v, device=dev) for k, v in pool[s % len(pool)].items()}
                   for s in range(first, first + n)]
        noise = rt.noise_draws(self.trainer_seed, pool[0]["pos"].shape, n, dev, first=first)
        out = rt.reference_steps(net, batches, noise, self.sigma, self.cell.config["denoiser"], self.optim,
                                 self.ema_decay, keep, block=int(self.mix["batch_size"]), state=state)
        del net
        return out

    def _f32_reference(self, after: bool) -> dict:
        from benchmark.reference.precision import F32

        if after not in self._refs:
            self._refs[after] = self._reference(F32, after=after)
        return self._refs[after]

    def check(self, prec=None, fault: str = "", detail: bool = False) -> Dict[str, float]:
        """The program's readings against the reference's, for the set-up's
        steps (`loss_gap`, ...) and for the steps after the window
        (`loss_gap_after`, ...); with `prec`, the reference in that
        precision in the program's place (the control); with `fault`
        ("half_batch"), the reference with that fault planted in the
        program's place. `detail` adds the leaves `change_gap` leaves out."""
        from benchmark.reference.precision import F32

        numbers = {}
        for after, program, suffix in ((False, self.program, ""), (True, self.program_after, "_after")):
            if prec is not None or fault:
                program = self._reference(prec or F32, keep={"": 1.0, "half_batch": 0.5}[fault], after=after)
            ref = self._f32_reference(after)
            numbers.update({k + suffix: v for k, v in rt.train_numbers(program, ref).items()})
            if detail:
                numbers["left_out" + suffix] = rt.left_out(ref)
        return numbers
