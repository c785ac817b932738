"""Training on autograd (port of visualcla_tpu/train/): the step, LoRA, the
data loader, train-state checkpoints and the CLI (``run_training``)."""
from .trainer import (  # noqa: F401
    TrainState,
    causal_lm_loss,
    make_train_step,
    make_optimizer,
    init_train_state,
    train_forward_logits,
    stage1_trainable,
    stage2_trainable,
)
