"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the repository root:
    python3 chip_smoke.py [--out FILE]

Phases (any failure exits non-zero; nothing is caught):
  1. build the hand-written kernels from jamun_tpu_torch/csrc/ (one nvcc per
     source, started together) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card, at the
     flagship width (hidden 120x0e + 32x1e, projector 56x0e) and the walk's
     shapes (N = 44, G = 256 and N = 112, G = 128), in bf16 and f32, and time
     kernel and plain version with CUDA events;
  3. drive the main path, walk-jump sampling through the port's entry points
     (E3Conv -> Denoiser.score -> BAOAB walk -> fused jump), at full flagship
     width with random weights from a seed: 4AA (N = 44, G = 256, 101 steps)
     and 5AA (N = 112, G = 128, 101 steps); launch counts are zeroed just
     before and read just after, and must show K1 once and K2 six times per
     score call;
  4. check the output: finite, the expected shape, the kernel path's score
     against the CPU plain path on a small input, and E(3) equivariance.
A torch.profiler trace of a short 4AA walk closes the run (device time by
kernel, device busy share). `--out FILE` writes every number as JSON. The
line before the last is a JSON object of per-kernel numbers; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

SIGMA = 0.04
TOL = {  # max |kernel - plain| / max |plain|, per compute dtype
    # f32: the same arithmetic in another summation order
    torch.float32: 1e-4,
    # bf16: the same rounding points, but an f32 sum that differs in its
    # last bits can round h, w or an aggregate to the neighbouring bf16
    # value (relative step 2^-8); a few such flips stay well under 3e-2
    torch.bfloat16: 3e-2,
}
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense tensor-core bf16; f32 FMA


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got: torch.Tensor, want: torch.Tensor):
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / max(want.float().abs().max().item(), 1e-30)


def profile_walk(den, batch, dev, steps: int) -> None:
    """torch.profiler over a short walk: device time by kernel and the share
    of the wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler

    sampler = SingleMeasurementSampler(
        BAOAB(MCMCConfig(delta=0.04, steps=steps, score_fn_clip=100.0)), SIGMA
    )
    g = torch.Generator(device=dev).manual_seed(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler.walk_jump(den, batch, batch.pos, g)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: a CPU op's self device time repeats the time
    # of the kernels it launched
    events = [
        e for e in prof.key_averages()
        if e.device_type != torch.autograd.DeviceType.CPU and e.self_device_time_total > 0
    ]
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"profile: {steps}-step walk, wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{sum(e.count for e in events)} device ops")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")


def main() -> int:
    args = sys.argv[1:]
    out_path = args[args.index("--out") + 1] if "--out" in args else None

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from jamun_tpu_torch.models.denoiser import Denoiser, DenoiserConfig, normalization_factors
    from jamun_tpu_torch.models.e3conv import E3Conv
    from jamun_tpu_torch.ops.cuda import conv_block as k2
    from jamun_tpu_torch.ops.cuda import edge_features as k1
    from jamun_tpu_torch.ops.cuda.build import build_all
    from jamun_tpu_torch.sampling.mcmc import BAOAB, MCMCConfig
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler
    from jamun_tpu_torch.utils.testing import make_test_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    logs = build_all([k1.KERNEL.name, k2.KERNEL.name])
    log(f"phase 1: built {list(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    config = DenoiserConfig(max_radius=1.0, average_squared_distance=0.5)
    c_in = normalization_factors(SIGMA, config.average_squared_distance)[0]
    models = {
        cdt: E3Conv(dtype=cdt, device=dev, seed=0) for cdt in (torch.bfloat16, torch.float32)
    }
    for m in models.values():
        m.output_gain.data.fill_(1.0)
        m.requires_grad_(False)
    cutoff = Denoiser(models[torch.float32], config).effective_radial_cutoff(SIGMA) / c_in

    sizes = {"4AA": (44, 256), "5AA": (112, 128)}
    batches = {
        label: make_test_batch(
            num_graphs=G, max_nodes=N, nodes_per_graph=[N] * G, max_bonds=2 * N, scale=0.35,
            device=dev,
        )
        for label, (N, G) in sizes.items()
    }

    # ---- phase 2: each kernel against its plain version ----
    results = {"edge_features": [], "conv_block": []}
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, batch in batches.items():
        G, N = batch.pos.shape[:2]
        pos = (batch.pos * c_in).contiguous()
        geo = (pos, batch.node_mask, batch.bond_src, batch.bond_dst, batch.bond_mask, cutoff, 32)
        for cdt in (torch.bfloat16, torch.float32):
            tag = f"{label} N={N} G={G} {str(cdt).split('.')[-1]}"
            ef, bf = k1.edge_features(*geo, cdt)
            ef_p, bf_p = k1.edge_features_plain(*geo, cdt)
            adj_mismatch = int((ef[..., 3] != ef_p[..., 3]).sum()) + int((bf[..., 3] != bf_p[..., 3]).sum())
            abs_e, rel_e = map(max, zip(rel_err(ef, ef_p), rel_err(bf, bf_p)))
            assert adj_mismatch == 0, f"K1 {tag}: {adj_mismatch} adjacency entries differ"
            assert rel_e <= TOL[cdt], f"K1 {tag}: rel err {rel_e:.3g} > {TOL[cdt]}"
            n_pairs = int(ef[..., 3].sum()) + int(bf[..., 3].sum())
            k1_bytes = (
                pos.numel() * 4 + batch.node_mask.numel() + batch.bond_src.numel() * 16
                + batch.bond_mask.numel() + (ef.numel() + bf.numel()) * ef.element_size()
            )
            row = dict(
                shape=tag, max_abs_err=abs_e, max_rel_err=rel_e, tol=TOL[cdt],
                ms=cuda_time_ms(lambda: k1.edge_features(*geo, cdt), 20),
                plain_ms=cuda_time_ms(lambda: k1.edge_features_plain(*geo, cdt), 3),
                bound_ms=k1_bytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
                dtype=str(cdt), N=N, G=G,
            )
            results["edge_features"].append(row)
            log(f"phase 2: K1 {tag}: max abs err {abs_e:.3g}, rel {rel_e:.3g} (tol {TOL[cdt]}); "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")

            model = models[cdt]
            for block_name, blk, S, V in (
                ("projector", model.ConvBlock_0, 56, 0),
                ("hidden", model._HiddenLayer_0.ConvBlock_0, 120, 32),
            ):
                x = torch.randn((G, N, S + 3 * V), generator=gen, device=dev).to(cdt)
                conv = blk.Conv_0
                w = k2.pack_block_weights(
                    conv.radial_nn, conv._post_linear, blk.IrrepsLinear_1, blk.IrrepsLinear_0,
                    model.embed_bondedness[0], model.embed_bondedness[1], S=S, V=V, cdt=cdt,
                )
                args_k2 = (x, ef, bf, batch.bond_src, batch.bond_dst, w)
                got = k2.fused_conv_block(*args_k2)
                want = k2.fused_conv_block_plain(*args_k2)
                torch.cuda.synchronize()
                assert torch.isfinite(got).all(), f"K2 {block_name} {tag}: non-finite output"
                abs_e, rel_e = rel_err(got, want)
                assert rel_e <= TOL[cdt], f"K2 {block_name} {tag}: rel err {rel_e:.3g} > {TOL[cdt]}"
                Wd = 2 * S + 3 * V
                Sc, Vg = w.Sc, w.Vg
                flops = 2 * n_pairs * (32 * 64 + 64 * Wd) + 2 * G * N * (
                    (S + V) * (Sc + Vg) + 3 * (S + 2 * V) * Vg + Sc * Sc + 3 * Vg * Vg
                    + S * Sc + 3 * V * Vg
                )
                k2_bytes = (
                    (x.numel() + ef.numel() + bf.numel()) * x.element_size()
                    + batch.bond_src.numel() * 16 + got.numel() * 4
                    + sum(t.numel() * t.element_size() for t in w if torch.is_tensor(t))
                )
                t_ops = flops / PEAK_FLOPS[cdt] * 1e3
                t_bytes = k2_bytes / PEAK_BYTES_PER_S * 1e3
                row = dict(
                    shape=f"{block_name} {tag}", max_abs_err=abs_e, max_rel_err=rel_e, tol=TOL[cdt],
                    ms=cuda_time_ms(lambda: k2.fused_conv_block(*args_k2), 10),
                    plain_ms=cuda_time_ms(lambda: k2.fused_conv_block_plain(*args_k2), 2),
                    bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                    visited_pairs=n_pairs, flops=flops, dtype=str(cdt), N=N, G=G, block=block_name,
                )
                results["conv_block"].append(row)
                log(f"phase 2: K2 {block_name} {tag}: max abs err {abs_e:.3g}, rel {rel_e:.3g} "
                    f"(tol {TOL[cdt]}); kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                    f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), {n_pairs} visited pairs")
                del got, want
            del ef, bf, ef_p, bf_p
            torch.cuda.empty_cache()

    # ---- phase 3: the main path, walk-jump at full flagship width ----
    den = Denoiser(models[torch.bfloat16], config)
    walks = {}
    k1.KERNEL.launches = 0
    k2.KERNEL.launches = 0
    score_calls = 0
    for label, batch in batches.items():
        G, N = batch.pos.shape[:2]
        steps = 101
        mcmc = BAOAB(MCMCConfig(delta=0.04, friction=1.0, M=1.0, steps=steps,
                                save_every_n_steps=1, score_fn_clip=100.0))
        sampler = SingleMeasurementSampler(mcmc, SIGMA)
        g = torch.Generator(device=dev).manual_seed(2)
        mask = batch.node_mask[..., None].float()
        y0 = batch.pos + SIGMA * torch.randn(batch.pos.shape, generator=g, device=dev) * mask
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sampler.walk_jump(den, batch, y0, g)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        score_calls += steps + 1  # the walk's initial score, steps - 1 updates, the final jump
        frames = out["xhat_traj"].shape[0]
        assert out["xhat_traj"].shape == (mcmc.config.num_saved_frames, G, N, 3)
        for k in ("y", "xhat", "y_traj", "xhat_traj"):
            assert torch.isfinite(out[k]).all(), f"{label}: non-finite {k}"
        ms_per_sample = dt * 1e3 / (G * frames)
        walks[label] = dict(N=N, G=G, steps=steps, frames=frames, seconds=dt,
                            ms_per_step=dt * 1e3 / steps, ms_per_sample=ms_per_sample)
        log(f"phase 3: walk-jump {label} N={N} G={G} steps={steps}: {dt:.3f} s, "
            f"{ms_per_sample:.6f} ms/sample, {dt * 1e3 / steps:.3f} ms/step on {card}")
    launches = {"edge_features": k1.KERNEL.launches, "conv_block": k2.KERNEL.launches}
    log(f"phase 3: launches {launches} over {score_calls} score calls")
    assert launches["edge_features"] == score_calls, launches
    assert launches["conv_block"] == 6 * score_calls, launches

    # ---- phase 4: the output against references ----
    small = make_test_batch(num_graphs=2, max_nodes=44, nodes_per_graph=[44, 41], max_bonds=88,
                            scale=0.35, device=dev)
    ref_model = E3Conv(dtype=None, device="cpu", plain=True)
    ref_model.load_state_dict(models[torch.float32].state_dict())
    ref_model.requires_grad_(False)
    with torch.no_grad():
        s_card = Denoiser(models[torch.float32], config).score(small, SIGMA)
        s_cpu = Denoiser(ref_model, config).score(small.to("cpu"), SIGMA)
    abs_e, rel_e = rel_err(s_card.cpu(), s_cpu)
    log(f"phase 4: f32 score, kernel path on the card vs plain path on the CPU: "
        f"max abs err {abs_e:.3g}, rel {rel_e:.3g} (tol 1e-3)")
    assert rel_e < 1e-3

    q, r = torch.linalg.qr(torch.randn(3, 3, generator=torch.Generator().manual_seed(5)))
    R = (q * torch.sign(torch.diagonal(r))).to(dev)
    if torch.det(R) < 0:
        R = -R
    shift = torch.tensor([0.3, -0.2, 0.5], device=dev)
    mask = small.node_mask[..., None].float()
    for cdt, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
        d = Denoiser(models[cdt], config)
        with torch.no_grad():
            s = d.score(small, SIGMA)
            s_rot = d.score(small.replace_pos((small.pos @ R.T + shift) * mask), SIGMA)
        err = ((s_rot - (s @ R.T - shift / SIGMA**2) * mask).abs().max() / s.abs().max()).item()
        log(f"phase 4: E(3) check {str(cdt).split('.')[-1]}: "
            f"|score(Ry+t) - (R score(y) - t/sigma^2)| / max|score| = {err:.3g} (tol {tol})")
        assert err < tol

    profile_walk(den, batches["4AA"], dev, steps=6)

    # ---- the report ----
    def main_row(rows, **match):
        return next(r for r in rows if all(r[k] == v for k, v in match.items()))

    k1_main = main_row(results["edge_features"], N=44, dtype=str(torch.bfloat16))
    k2_main = main_row(results["conv_block"], N=44, dtype=str(torch.bfloat16), block="hidden")
    kernels = []
    for name, main, replaces in (
        ("edge_features", k1_main, "jamun_tpu/ops/pallas/packed_conv.py:806"),
        ("conv_block", k2_main, "jamun_tpu/ops/pallas/packed_conv.py:1495"),
    ):
        kernels.append(dict(
            name=name, route="cuda", source=f"jamun_tpu_torch/csrc/{name}.cu", replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in results[name]),
            ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=None,
        ))
    report = dict(card=card, compare=results, walks=walks, launches=launches)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    log("walks: " + json.dumps(walks))
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
