"""Analysis of sampled runs (counterpart of `jamun_tpu/analysis/`): so far
`load_trajectory.py`, the run directory's trajectories and the sampling-time
CSV. MSM, TICA and the sweeps are
ROADMAP.md queue A, 'The analysis scripts'."""
