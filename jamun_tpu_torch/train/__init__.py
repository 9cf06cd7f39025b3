"""Training: sigma distributions, LR schedules, optax's optimizers, EMA, the
train state and steps, checkpoints, loggers, diagnostics and the Trainer
(counterpart of `jamun_tpu/train/`)."""

from jamun_tpu_torch.train.checkpoints import (
    CheckpointManager,
    find_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from jamun_tpu_torch.train.distributions import (
    CategoricalValue,
    ClippedLogNormalSigma,
    ConstantSigma,
    ExponentialSigma,
    UniformMeasurement,
    UniformPlusNormal,
    UniformSigma,
    WeightedMeasurement,
)
from jamun_tpu_torch.train.ema import ema_init, ema_update
from jamun_tpu_torch.train.loggers import ConsoleLogger, CSVLogger, MultiLogger, maybe_wandb_logger
from jamun_tpu_torch.train.loop import Trainer, TrainerConfig
from jamun_tpu_torch.train.lr_schedules import linear, linear_warmup_linear_decay, linear_warmup_plateau
from jamun_tpu_torch.train.state import TrainState, create_train_state, make_eval_step, make_train_step
