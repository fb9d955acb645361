from ampnet_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_checkpoint_params,
    load_params,
    restore_best,
    resume_or_create,
    save_checkpoint,
    save_params,
)
from ampnet_tpu_torch.train.loop import train_full_batch, train_saint
from ampnet_tpu_torch.train.losses import (
    masked_accuracy,
    masked_mean_nll,
    nll_loss,
    saint_weighted_mean_nll,
    saint_weighted_nll,
)
from ampnet_tpu_torch.train.optim import cosine_warm_restarts, make_optimizer
from ampnet_tpu_torch.train.profiling import StepTimer, StepTraceCapture, trace
from ampnet_tpu_torch.train.rundir import Logfile, create_run_dir
from ampnet_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_predict_step,
    make_scan_train_step,
    make_train_step,
)

__all__ = [
    "cosine_warm_restarts", "make_optimizer", "nll_loss",
    "masked_mean_nll", "masked_accuracy", "TrainState", "create_train_state",
    "make_train_step", "make_scan_train_step", "make_eval_step",
    "make_predict_step", "save_checkpoint", "load_checkpoint",
    "load_checkpoint_params", "save_params", "load_params", "restore_best", "resume_or_create",
    "train_full_batch", "train_saint", "saint_weighted_nll",
    "saint_weighted_mean_nll", "create_run_dir", "Logfile", "trace",
    "StepTraceCapture", "StepTimer",
]
