"""The walk traffic: walk-jump sampling through the sample CLI's path.

The window calls `Sampler.sample(denoiser, SingleMeasurementSampler(BAOAB(
...)), num_batches=1, init_graphs, continue_chain=False, seed=...)` again and
again on the same seeded structures, so the load under random weights is the
same in every batch, and ends when the batch running at the deadline
finishes. Each call walks `steps` BAOAB steps (every state saved), jumps
every saved frame and unbatches to host arrays, as the CLI pays it.

Mix parameters (the traffic file): `sequences` x `chains_per_sequence`
chains, each sequence of `residues` residues (one drawn from the list) with
at most `max_atoms` heavy atoms, backbone basins and jitter, padded to
`bucket` atoms; `steps` a batch; the MCMC settings; `check_chains` chains,
`check_per_batch` drawn from each batch, for the reference; `trace_steps`
walk steps in the profiled slice; `check_chunk` graphs per reference block;
`structure_seed` and `weight_seed`, which fix the molecules and the random
weights, so that every run does the same work (under random weights the
structures, and with them the pairs the kernels visit, drift at a pace the
weights set). The run's seed orders the chains and draws the noise.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.costs import e3conv as costs
from benchmark.inputs.batches import walk_batch
from benchmark.reference import walk as rw
from benchmark.reference.denoiser import factors, mean_center

__all__ = ["Driver"]


class _TimedScore:
    """The denoiser with the host time of each `score` call recorded (no
    synchronisation: the time to enqueue the forward)."""

    def __init__(self, denoiser):
        self._den = denoiser
        self.times: List[float] = []

    def score(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self._den.score(*args, **kwargs)
        self.times.append(time.perf_counter() - t0)
        return out

    def __getattr__(self, name):
        return getattr(self._den, name)


class Driver:
    kind = "walk"

    def __init__(self, cell):
        self.cell = cell
        self.mix = cell.mix
        self.sigma = float(self.mix["sigma"])
        self.mcmc = dict(self.mix["mcmc"])

    # ---- set-up ----

    def setup(self) -> None:
        from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
        from jamun_tpu_torch.models.e3conv import E3Conv
        from jamun_tpu_torch.ops.graph import GraphBatch
        from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
        from jamun_tpu_torch.sampling.sampler import Sampler
        from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler

        cell, dev = self.cell, self.cell.device
        arch = dict(cell.config["arch"])
        arch.pop("_target_", None)
        # the sample CLI's default on the card: the whole-model kernel for
        # calls without a gradient where the kernels are on
        arch["fused_stack"] = bool(arch.get("use_pallas", True)) and dev.type == "cuda"
        self.weights = cell.make_weights()
        net = E3Conv(**arch, device=dev)
        net.load_state_dict(self.weights, strict=True)
        net.requires_grad_(False)
        self.denoiser = Denoiser(net, DenoiserConfig(**cell.config["denoiser"]))
        self.graphs_np = walk_batch(cell.seed, self.mix)
        self.graphs = {k: torch.as_tensor(v, device=dev) for k, v in self.graphs_np.items()}
        self.init = GraphBatch(**self.graphs)
        cfg = MCMCConfig(steps=int(self.mix["steps"]), **self.mcmc)
        self.sampler_cfg = cfg
        self.batch_sampler = SingleMeasurementSampler(BAOAB(cfg), sigma=self.sigma)
        self.sampler = Sampler(device=dev)
        self._sample(self.denoiser, self.batch_sampler, self._batch_seed(-1))  # warm-up: one whole batch
        self._sync()

    def _sync(self):
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def _batch_seed(self, i: int) -> int:
        return int(self.cell.seed) * 1000 + 1 + i

    def _sample(self, denoiser, batch_sampler, seed: int):
        return self.sampler.sample(denoiser, batch_sampler, 1, self.init, continue_chain=False, seed=seed)[0]

    # ---- the window ----

    def run(self, seconds: float, on_window_start, keep_frames: bool) -> Dict[str, float]:
        """The window; `on_window_start` is called when set-up is over (the
        harness takes the set-up time there). With `keep_frames` every
        batch's frames are kept for the count of the window's operations."""
        on_window_start()
        G_real = int(self.graphs_np["graph_mask"].sum())
        frames = self.sampler_cfg.num_saved_frames
        per_batch = self.mix["check_per_batch"]
        self.kept, self.window_frames, n = [], [], 0
        self._sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            seed = self._batch_seed(n)
            samples = self._sample(self.denoiser, self.batch_sampler, seed)
            rng = np.random.default_rng([self.cell.seed, 3, n])
            for g in sorted(rng.choice(len(samples), size=per_batch, replace=False).tolist()):
                s = samples[g]
                self.kept.append((seed, s["graph_index"], np.array(s["y_traj"]), np.array(s["xhat_traj"])))
            if keep_frames:
                self.window_frames.append([s["y_traj"] for s in samples])
            n += 1
            if time.perf_counter() >= deadline:
                break
        self._sync()
        self.window_s = time.perf_counter() - t0
        self.batches, self.chains = n, G_real
        return {"walk_ms_per_sample": 1e3 * self.window_s / (n * G_real * frames)}

    def attempted(self) -> int:
        """Chains walked in the window."""
        return self.batches * self.chains

    def failed(self) -> int:
        """Chains kept for the check whose frames or jumps are not finite."""
        return sum(not (np.isfinite(y).all() and np.isfinite(x).all()) for _, _, y, x in self.kept)

    # ---- what the per-layer metrics read ----

    def _widths(self) -> dict:
        arch = self.cell.config["arch"]
        S, V = (int(t.strip().split("x")[0]) for t in arch["irreps_hidden"].split("+"))
        S_emb = sum(arch[k] for k in ("atom_type_embedding_dim", "atom_code_embedding_dim",
                                      "residue_code_embedding_dim", "residue_index_embedding_dim"))
        return costs.kernel_widths(S, V, S_emb)

    def _forward_pairs(self, y_traj_per_graph: List[np.ndarray]) -> np.ndarray:
        """Visited pairs of every forward of a batch (one per saved frame, then
        the final jump at the last frame), summed over its graphs."""
        dev, N = self.cell.device, self.graphs_np["pos"].shape[1]
        c_in = factors(self.sigma, self.cell.config["denoiser"]["average_squared_distance"])[0]
        cutoff = (self.cell.config["denoiser"]["max_radius"] ** 2 + 6 * self.sigma**2) ** 0.5 / c_in
        mask, bonds = self.graphs["node_mask"], self.graphs["bond_mask"]
        F = y_traj_per_graph[0].shape[1]
        total = torch.zeros(F, dtype=torch.int64, device=dev)
        for g, y in enumerate(y_traj_per_graph):
            n = y.shape[0]
            pos = torch.zeros((F, N, 3), device=dev)
            pos[:, :n] = torch.as_tensor(y, device=dev).transpose(0, 1)
            m = mask[g:g + 1].expand(F, N)
            total += costs.visited_pairs(mean_center(pos, m) * c_in, m, bonds[g:g + 1].expand(F, -1), cutoff)
        pairs = total.cpu().numpy()
        return np.concatenate([pairs, pairs[-1:]])

    def _flops(self, pairs: np.ndarray) -> int:
        nodes = int(self.graphs_np["node_mask"].sum())
        layers = int(self.cell.config["arch"]["n_layers"])
        return sum(costs.separable_forward_flops(int(p), nodes, self._widths(), layers) for p in pairs)

    def _bounds(self, pairs: np.ndarray) -> Dict[str, float]:
        """Seconds the chip would need at its peaks for the slice's K3 launches
        (one per forward) and K5 launches (one per block and forward)."""
        w, G, N = self._widths(), *self.graphs_np["pos"].shape[:2]
        B = self.graphs_np["bond_src"].shape[1]
        nodes = int(self.graphs_np["node_mask"].sum())
        layers, cdt = int(self.cell.config["arch"]["n_layers"]), 2 if self.bf16 else 4
        peak = self.peak_flops
        stack = tiled = 0.0
        for p in pairs:
            stack += costs.roofline_ms(*costs.stack_launch(int(p), nodes, G, N, B, w, layers, cdt), peak)
            tiled += costs.roofline_ms(*costs.tiled_launch(int(p), nodes, G, N, B, w["S_emb"], 0, w, cdt), peak)
            tiled += layers * costs.roofline_ms(
                *costs.tiled_launch(int(p), nodes, G, N, B, w["S"], w["V"], w, cdt), peak)
        return {"e3_stack": 1e-3 * stack, "fused_block_tiled": 1e-3 * tiled}

    @property
    def bf16(self) -> bool:
        return self.cell.config["arch"].get("dtype") == "bfloat16"

    @property
    def peak_flops(self) -> float:
        return costs.peaks()["bf16_flops" if self.bf16 else "f32_flops"]

    def readings(self, profile_slice) -> dict:
        """After the window: the window's model operations, a host-timed slice
        and a profiled slice of `trace_steps` walk steps."""
        import dataclasses

        flops = sum(self._flops(self._forward_pairs(b)) for b in self.window_frames)
        self.window_frames = []
        cfg = dataclasses.replace(self.sampler_cfg, steps=int(self.mix["trace_steps"]) + 1)
        from jamun_tpu_torch.sampling.mcmc import BAOAB
        from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler

        slice_sampler = SingleMeasurementSampler(BAOAB(cfg), sigma=self.sigma)
        timed = _TimedScore(self.denoiser)
        self._sample(timed, slice_sampler, self._batch_seed(10**6))
        self._sync()
        out = {}
        prof = profile_slice(lambda: out.setdefault("s", self._sample(self.denoiser, slice_sampler,
                                                                       self._batch_seed(10**6 + 1))),
                             steps=int(self.mix["trace_steps"]))
        pairs = self._forward_pairs([s["y_traj"] for s in out["s"]])
        return dict(
            kind="walk", slice=prof, window_s=self.window_s, window_flops=flops, peak_flops=self.peak_flops,
            score_host_ms=1e3 * float(np.mean(timed.times)), bounds=self._bounds(pairs),
        )

    # ---- the check ----

    def release(self) -> None:
        del self.denoiser, self.sampler, self.batch_sampler, self.init

    def check(self, prec=None, detail: bool = False) -> Dict[str, float]:
        """The reference's numbers over `check_chains` of the chains kept from
        the window (drawn from the seed); with `prec`, the reference in that
        precision in the program's place (the control), at the same frames;
        `detail` adds the numbers `walk_numbers` gives for calibration."""
        from benchmark.reference.model import E3Conv as RefNet

        dev = self.cell.device
        rng = np.random.default_rng([self.cell.seed, 4])
        pick = sorted(rng.choice(len(self.kept), size=min(self.mix["check_chains"], len(self.kept)),
                                 replace=False).tolist())
        chosen = [self.kept[i] for i in pick]
        N = self.graphs_np["pos"].shape[1]
        ref = RefNet(self.cell.config["arch"]).to(dev)
        ref.load_state_dict(self.weights, strict=True)
        ctrl = None
        if prec is not None:
            ctrl = RefNet(self.cell.config["arch"], prec).to(dev)
            ctrl.load_state_dict(self.weights, strict=True)
        den_cfg, chunk = self.cell.config["denoiser"], int(self.mix["check_chunk"])
        G = self.graphs_np["pos"].shape[0]
        results = []
        for seed in sorted({c[0] for c in chosen}):
            rows = [c for c in chosen if c[0] == seed]
            idx = torch.as_tensor([c[1] for c in rows], device=dev)
            F = rows[0][2].shape[1]
            y = torch.zeros((len(rows), F, N, 3), device=dev)
            xh = torch.zeros_like(y)
            for k, (_, _, yt, xt) in enumerate(rows):
                y[k, :, : yt.shape[0]] = torch.as_tensor(yt, device=dev).transpose(0, 1)
                xh[k, :, : xt.shape[0]] = torch.as_tensor(xt, device=dev).transpose(0, 1)
            d = rw.draws(seed, (G, N, 3), F - 1, dev)
            mask = self.graphs["node_mask"][idx]
            graphs = {k: v[idx] for k, v in self.graphs.items()}
            start = graphs["pos"] + self.sigma * d[0][idx] * mask[..., None]
            noise = torch.stack([torch.zeros_like(d[0])] + d[2:], dim=1)[idx]
            xh_ref, s_ref = rw.frame_scores(ref, graphs, y, self.sigma, den_cfg, chunk)
            pred = rw.follow(y, s_ref, d[1][idx], noise, mask, self.mcmc)
            if ctrl is None:
                results.append(rw.walk_numbers(y, xh, y, start, pred, xh_ref, mask, detail))
            else:
                xh_c, s_c = rw.frame_scores(ctrl, graphs, y, self.sigma, den_cfg, chunk)
                y_c = torch.cat([start[:, None], rw.follow(y, s_c, d[1][idx], noise, mask, self.mcmc)], dim=1)
                results.append(rw.walk_numbers(y_c, xh_c, y, start, pred, xh_ref, mask, detail))
        del ref, ctrl
        return {k: max(r[k] for r in results) for k in results[0]}
