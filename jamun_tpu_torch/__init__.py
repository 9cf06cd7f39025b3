"""jamun_tpu_torch: the PyTorch/CUDA port of jamun_tpu for one NVIDIA H100.

The JAX package `jamun_tpu` is the reference; this package imports neither it
nor JAX. Layout mirrors it: `ops/` (irreps, SH, radial basis, graph, linear,
gate, MLPs, the separable conv), `ops/cuda/` (the hand-written Hopper kernels
and their plain PyTorch twins, sources in `csrc/`), `models/` (E3Conv,
Ophiuchus, Denoiser with its training loss), `sampling/` (BAOAB and its
chunked form, walk-jump, VESDE), `train/`
(sigma distributions, LR schedules, EMA, train state and steps, Trainer,
checkpoints in the port's format and JAX's), `data/`, `config/`,
`metrics/` (sampling metrics), `analysis/` (run trajectories and sampling
rates), `cmdline/` (the train and sample CLIs), `utils/`, and `params.py`
(the flax param and train-state bridge).
"""
