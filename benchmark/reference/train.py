"""The training step's check: the reference trains the same weights on the
same batches and the same noise for the first steps, and again for the
steps after the window from the state the program had reached (its
parameters, Adam's moments and count, the EMA), and the program's readings
are compared with its own.

One reference step (JAMUN's denoiser loss, `train_uncapped_4AA`'s settings):
the clean batch mean-centred, noise of sigma drawn, the noisy batch
mean-centred and Kabsch-aligned onto the clean one, the denoiser's xhat,
the loss (the mean over the graphs of the scaled per-graph loss), its
gradient by autograd, then optax's Adam and the EMA of the parameters.

The numbers, each against the reference:
  loss_gap: the widest relative gap of a step's loss;
  grad_gap: the first gradient, as the program's Adam holds it after one
    step (its first moment over 1 - b1): the widest gap between a leaf's
    norm in the program and in the reference, over the larger of that
    leaf's reference norm and the median leaf's;
  change_gap: the same for the change of each parameter and of its EMA
    over the steps. Leaves whose reference gradient is below a thousandth
    of the median leaf's are left out: Adam moves them by round-off alone
    (`left_out` names them).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark.reference import denoiser as rd
from benchmark.reference.model import E3Conv

__all__ = ["noise_draws", "reference_steps", "train_numbers", "left_out"]


def noise_draws(seed: int, shape, steps: int, device, first: int = 0) -> List[torch.Tensor]:
    """The training noise of steps `first` .. `first + steps - 1` (from 0):
    one draw of the batch's shape a step from a generator seeded with the
    trainer's seed."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draws = [torch.randn(tuple(shape), generator=gen, device=device) for _ in range(first + steps)]
    return draws[first:]


def reference_steps(net: E3Conv, batches: List[Dict[str, torch.Tensor]], noise: List[torch.Tensor],
                    sigma: float, config: dict, optim: dict, ema_decay: float, keep: float = 1.0,
                    block: int = 0, state: Optional[dict] = None) -> dict:
    """Train `net` in place for len(batches) steps. Returns the losses, the
    first step's gradients and, per leaf, the change of the parameters and
    of their EMA. `state` continues a run: Adam's moments "mu" and "nu" and
    the EMA "ema" by leaf, and Adam's step "count" before the first step
    (fresh moments, the EMA at the parameters and count 0 without it).
    `block` > 0 takes each batch's loss and gradient in blocks of that many
    graphs (the gradients summed), so that a batch larger than the card
    holds at once fits. `keep` < 1 plants a fault for the check's
    calibration: the loss is the mean over that first share of each batch's
    graphs alone (a half: half of the batch left out)."""
    params = dict(net.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    if state is None:
        ema = {k: p.detach().clone() for k, p in params.items()}
        mu = {k: torch.zeros_like(p) for k, p in params.items()}
        nu = {k: torch.zeros_like(p) for k, p in params.items()}
        t0 = 0
    else:
        ema, mu, nu = ({k: v[k].clone() for k in params} for v in (state["ema"], state["mu"], state["nu"]))
        t0 = int(state["count"])
    ema_start = {k: v.clone() for k, v in ema.items()}
    b1, b2, eps, lr = optim["b1"], optim["b2"], optim["eps"], optim["learning_rate"]
    losses, grad1 = [], None
    for t, (b, eps_noise) in enumerate(zip(batches, noise), start=t0 + 1):
        G = b["pos"].shape[0]
        gm_all = b["graph_mask"].to(torch.float32)
        if keep < 1.0:
            gm_all = gm_all * (torch.arange(G, device=gm_all.device) < round(G * keep)).to(gm_all.dtype)
        count = torch.clamp(gm_all.sum(), min=1.0)
        net.zero_grad(set_to_none=True)
        loss_value = 0.0
        for sl, c in rd.chunks(dict(b, noise=eps_noise, gm=gm_all), block or G):
            mask = c["node_mask"]
            x = rd.mean_center(c["pos"], mask)
            y = rd.mean_center(x + float(sigma) * c["noise"] * mask[..., None].to(x.dtype), mask)
            y = rd.kabsch_align(y, x, mask)
            per_graph = rd.per_graph_loss(rd.xhat(net, c, y, sigma, config), x, c, sigma, config)
            loss = (per_graph * c["gm"]).sum() / count
            loss.backward()
            loss_value += float(loss.detach())
        losses.append(loss_value)
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in params.items()}
        if grad1 is None:
            grad1 = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                step = (mu[k] / (1 - b1**t)) / (torch.sqrt(nu[k] / (1 - b2**t)) + eps)
                p.sub_(lr * step)
                ema[k].mul_(ema_decay).add_(p, alpha=1 - ema_decay)
    return {
        "losses": losses,
        "grad1": grad1,
        "change": {k: params[k].detach() - start[k] for k in params},
        "ema_change": {k: ema[k] - ema_start[k] for k in params},
    }


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64))) for k, v in d.items()}


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2])


def _leaf_gap(got: Dict[str, float], want: Dict[str, float], keys) -> float:
    med = _median([want[k] for k in keys])
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys)


def _moved(g_ref: Dict[str, float]) -> List[str]:
    med = _median(list(g_ref.values()))
    return sorted(k for k, v in g_ref.items() if v >= 1e-3 * med)


def left_out(ref: dict) -> Dict[str, float]:
    """The leaves `change_gap` leaves out: name -> the norm of the
    reference's first gradient over the median leaf's."""
    g_ref = _norms(ref["grad1"])
    med = _median(list(g_ref.values()))
    kept = set(_moved(g_ref))
    return {k: v / med for k, v in sorted(g_ref.items()) if k not in kept}


def train_numbers(program: dict, ref: dict) -> Dict[str, float]:
    """`program` holds the same keys as `reference_steps`' result, read from
    the program's run."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(program["losses"], ref["losses"]))
    g_ref = _norms(ref["grad1"])
    keys = sorted(g_ref)
    moved = _moved(g_ref)
    change = _leaf_gap(_norms(program["change"]), _norms(ref["change"]), moved)
    ema = _leaf_gap(_norms(program["ema_change"]), _norms(ref["ema_change"]), moved)
    return {
        "loss_gap": loss_gap,
        "grad_gap": _leaf_gap(_norms(program["grad1"]), g_ref, keys),
        "change_gap": max(change, ema),
    }
