"""Training: sigma distributions, LR schedules, EMA, the train state and steps, the Trainer."""
