"""The check fails what it has to fail: each fault a cell can have, planted
under the timed path of a whole run (the harness's look for a card skipped),
and the control in the program's place, at a size the CPU runs."""

import pytest
import torch

from benchmark import harness
from benchmark.reference.precision import Precision


def _run(cell):
    return harness.run(cell, 0.2, False, lambda: 0.0)


def test_sound_runs_pass(cell_factory):
    for workload in ("sep_walk_4AA", "uvw_train_4AA"):
        assert _run(cell_factory(workload))["correct"]


def _walk_step_unchanged(orig):
    def step(self, carry, R, processed):
        return carry

    return step


def _walk_half_the_chains(orig):
    def step(self, carry, R, processed):
        new = orig(self, carry, R, processed)
        half = carry[0].shape[0] // 2
        return tuple(torch.cat([n[:half], c[half:]]) for n, c in zip(new, carry))

    return step


@pytest.mark.parametrize("fault", [_walk_step_unchanged, _walk_half_the_chains])
def test_walk_faults_fail(cell_factory, monkeypatch, fault):
    from jamun_tpu_torch.sampling.mcmc import BAOAB

    monkeypatch.setattr(BAOAB, "step", fault(BAOAB.step))
    out = _run(cell_factory("sep_walk_4AA"))
    assert not out["correct"], out["checks"]


def test_walk_answer_altered_fails(cell_factory, monkeypatch):
    from jamun_tpu_torch.sampling.walkjump import SingleMeasurementSampler

    orig = SingleMeasurementSampler.walk_jump

    def walk_jump(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        out["xhat_traj"][-1] += 0.005  # nm, on the last frame of every chain
        return out

    monkeypatch.setattr(SingleMeasurementSampler, "walk_jump", walk_jump)
    out = _run(cell_factory("sep_walk_4AA"))
    assert not out["correct"], out["checks"]
    assert out["checks"]["walk_gap"]["value"] <= out["checks"]["walk_gap"]["limit"]


def test_train_step_unchanged_fails(cell_factory, monkeypatch):
    from jamun_tpu_torch.train import state as train_state
    from jamun_tpu_torch.train.optim import Adam

    monkeypatch.setattr(Adam, "step", lambda self, closure=None: None)
    monkeypatch.setattr(train_state, "ema_update", lambda *args, **kwargs: None)
    out = _run(cell_factory("uvw_train_4AA"))
    assert not out["correct"], out["checks"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert out["checks"]["change_gap_after"]["value"] == pytest.approx(1.0)


def test_train_fault_after_the_setup_steps_fails(cell_factory, monkeypatch):
    """A step that goes wrong only once the set-up's steps are done (each
    optimizer step taken twice, as a replayed update would) passes the
    set-up's numbers and fails those of the steps after the window."""
    from jamun_tpu_torch.train.optim import Adam

    cell = cell_factory("uvw_train_4AA")
    orig = Adam.step

    def step(self, closure=None):
        orig(self)
        if self.param_groups[0]["count"] > int(cell.mix["check_steps"]):
            orig(self)

    monkeypatch.setattr(Adam, "step", step)
    out = _run(cell)
    checks = out["checks"]
    assert not out["correct"], checks
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in ("loss_gap", "grad_gap", "change_gap")), checks
    assert checks["change_gap_after"]["value"] > checks["change_gap_after"]["limit"], checks


def test_train_half_the_batch_fails(cell_factory, monkeypatch):
    from jamun_tpu_torch.models import denoiser

    orig = denoiser.masked_graph_mean

    def half(per_graph, aux, graph_mask):
        keep = torch.arange(graph_mask.shape[0], device=graph_mask.device) < graph_mask.shape[0] // 2
        return orig(per_graph, aux, graph_mask & keep)

    monkeypatch.setattr(denoiser, "masked_graph_mean", half)
    out = _run(cell_factory("uvw_train_4AA"))
    assert not out["correct"], out["checks"]


def test_train_loss_altered_fails(cell_factory, monkeypatch):
    from jamun_tpu_torch.models.denoiser import Denoiser

    orig = Denoiser.training_loss

    def altered(self, *args, **kwargs):
        loss, aux = orig(self, *args, **kwargs)
        aux["loss"] = aux["loss"] * 1.01
        return loss, aux

    monkeypatch.setattr(Denoiser, "training_loss", altered)
    out = _run(cell_factory("uvw_train_4AA"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload, separating", [("sep_walk_4AA", ("walk_gap", "xhat_gap")),
                                                   ("uvw_train_4AA", ("grad_gap", "change_gap", "grad_gap_after"))])
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2])
def test_the_control_reads_apart_from_the_program(cell_factory, workload, separating, seed):
    """The reference in the next precision below the configuration's (fp8
    for the bf16 walk, TF32 for the f32 training) in the program's place
    reads at least three times what the program reads on the same seed.
    At the cell's own size on the card its readings pass the committed
    limits (PERF.md); the widest gaps of this small size are smaller, so
    here the separation is what is held."""
    cell = cell_factory(workload, seed)
    driver = harness.driver_for(cell)
    driver.setup()
    driver.run(0.2, lambda: None, keep_frames=False)
    driver.release()
    program = driver.check()
    control = driver.check(Precision(cell.config["control"]))
    assert all(control[k] >= 3 * program[k] for k in separating), (program, control)
