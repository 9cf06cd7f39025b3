"""Analysis of sampled runs (counterpart of `jamun_tpu/analysis/`): the run
directory's trajectories and the sampling-time CSV (`load_trajectory`),
TICA (`tica`), k-means and the MSM (`msm`), the per-label comparison with
reference MD and its CLI (`run_analysis`), and the sweep over a run's
labels (`analysis_sweep`). Host numpy, as in JAX."""
