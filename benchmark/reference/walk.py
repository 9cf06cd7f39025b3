"""The walk's check: the reference follows the walk-jump sampler over frames
that the program produced.

The walk is a chain, and the reference cannot walk it alone: its float32
scores differ from the program's in the last bits, and the chain then
drifts apart. So it follows the program step by step. From each saved frame
y[t-1] it takes one BAOAB step (Leimkuhler-Matthews, friction `friction`,
the clipped score at y[t-1]) with the Gaussian draw the sampler's generator
gives at that step, and predicts y[t]. The velocity it carries is its own,
started from the generator's draw and updated with its own scores at the
program's frames. The start is checked by itself: y[0] against the initial
structure plus sigma times the generator's first draw. The jump is checked
at every frame: the program's xhat against the reference's denoiser at the
program's y.

Two numbers come out, each the widest over the checked chains and frames
of a frame's root mean square gap over its real atoms, over a typical size
(a root mean square over all the frames):
  walk_gap: y_program - y_predicted, over the RMS move of an atom in one
    step of the program's walk;
  xhat_gap: xhat_program - xhat_reference, over the RMS of
    xhat_reference - y (the denoiser's correction).
A frame's RMS and not one atom's gap: a pair at the cutoff's edge is in the
edge set on one side and out of it on the other when their distances differ
in the last bit, and the basis does not vanish there, so one atom's gap has
a tail that is no fault of either side; a frame's RMS spreads it over the
frame's atoms. `detail=True` adds the widest single atom's gaps
(`walk_gap_atom`, `xhat_gap_atom`), which the check does not compare.

The Gaussian draws are made again here, from the seed of each batch, on a
generator of the same kind as the sampler's: the same seed gives the same
draws. The sampler draws, in order, the start's noise, the initial velocity,
then one draw per update, each of the whole batch's shape.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from benchmark.reference import denoiser as rd
from benchmark.reference.model import E3Conv

__all__ = ["draws", "clip", "frame_scores", "follow", "walk_numbers"]


def draws(seed: int, shape, updates: int, device) -> List[torch.Tensor]:
    """The sampler's Gaussian draws of one batch: start, velocity, then one
    per update."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return [torch.randn(tuple(shape), generator=gen, device=device) for _ in range(updates + 2)]


def clip(score: torch.Tensor, limit: Optional[float]) -> torch.Tensor:
    if limit is None:
        return score
    norm = torch.linalg.vector_norm(score, dim=-1, keepdim=True)
    return score / torch.clamp(norm, min=1e-20) * torch.clamp(norm, max=limit)


def frame_scores(net: E3Conv, graphs: Dict[str, torch.Tensor], frames: torch.Tensor, sigma: float,
                 config: dict, chunk: int):
    """The reference's xhat and score at frames [C, F, N, 3] of C chains
    (graphs: C graphs' features), computed over the frames folded into the
    graph axis in blocks of `chunk` graphs."""
    C, Fr = frames.shape[:2]
    flat = {k: v.repeat_interleave(Fr, dim=0) for k, v in graphs.items()}
    flat["pos"] = frames.reshape((C * Fr,) + tuple(frames.shape[2:]))
    xh = torch.empty_like(flat["pos"])
    with torch.no_grad():
        for sl, b in rd.chunks(flat, chunk):
            xh[sl] = rd.xhat(net, b, b["pos"], sigma, config)
    xh = xh.reshape(frames.shape)
    return xh, (xh - frames) / float(sigma) ** 2


def follow(y: torch.Tensor, scores: torch.Tensor, v0: torch.Tensor, noise: torch.Tensor, mask: torch.Tensor,
           mcmc: dict) -> torch.Tensor:
    """BAOAB from each frame y[:, t-1] to a predicted y[:, t] (t >= 1), in
    float64: scores [C, F, N, 3] the raw scores at the frames, v0 [C, N, 3]
    the initial velocity draw, noise [C, F, N, 3] the draw of each update
    (index t for the update that makes frame t). Returns the predictions
    [C, F - 1, N, 3]."""
    f64 = torch.float64
    y, scores, noise = y.to(f64), scores.to(f64), noise.to(f64)
    m = mask[..., None].to(f64)
    u = 1.0 / mcmc["M"]
    d2 = mcmc["delta"] / 2.0
    damp = math.exp(-mcmc["friction"])
    zeta2 = math.sqrt(1.0 - math.exp(-2.0 * mcmc["friction"]))
    psi = clip(scores, mcmc["score_fn_clip"]) * mcmc.get("inverse_temperature", 1.0)
    v = math.sqrt(u) * v0.to(f64) * m
    out = []
    for t in range(1, y.shape[1]):
        v1 = v + u * d2 * psi[:, t - 1]
        vhat = damp * v1 + zeta2 * math.sqrt(u) * noise[:, t] * m
        out.append(y[:, t - 1] + d2 * v1 + d2 * vhat)
        v = vhat + d2 * psi[:, t]
    return torch.stack(out, dim=1)


def walk_numbers(y_out: torch.Tensor, xhat_out: torch.Tensor, y: torch.Tensor, start: torch.Tensor,
                 pred: torch.Tensor, xhat_ref: torch.Tensor, mask: torch.Tensor,
                 detail: bool = False) -> Dict[str, float]:
    """The two gaps of the module doc. y_out, xhat_out [C, F, N, 3]: the
    frames and jumps under test; y: the program's frames, at which the
    reference evaluated xhat_ref and from which it predicted the start
    [C, N, 3] and the steps pred [C, F - 1, N, 3]. For the program y_out is
    y; a control's y_out holds its own steps from the same frames."""
    f64 = torch.float64
    y, y_out, xhat_out, xhat_ref = y.to(f64), y_out.to(f64), xhat_out.to(f64), xhat_ref.to(f64)
    m = mask[:, None, :, None].to(f64)
    atoms = 3 * mask.to(f64).sum(-1)[:, None]  # coordinates of a frame [C, 1]

    def rms(t: torch.Tensor) -> torch.Tensor:
        w = m.expand_as(t)
        return torch.sqrt((t * t * w).sum() / w.sum())

    def frame_rms(t: torch.Tensor) -> torch.Tensor:
        return torch.sqrt((t * t * m).sum((-1, -2)) / atoms)  # [C, frames]

    step = rms(y[:, 1:] - y[:, :-1])
    correction = rms(xhat_ref - y)
    walk = torch.cat([frame_rms((y_out[:, :1] - start[:, None].to(f64))), frame_rms(y_out[:, 1:] - pred.to(f64))], 1)
    out = {
        "walk_gap": float(walk.max() / step),
        "xhat_gap": float(frame_rms(xhat_out - xhat_ref).max() / correction),
    }
    if detail:
        out["walk_gap_atom"] = float(torch.maximum(
            ((y_out[:, 1:] - pred.to(f64)) * m).abs().amax(),
            ((y_out[:, 0] - start.to(f64)) * m[:, 0]).abs().amax()) / step)
        out["xhat_gap_atom"] = float(((xhat_out - xhat_ref) * m).abs().amax() / correction)
    return out
