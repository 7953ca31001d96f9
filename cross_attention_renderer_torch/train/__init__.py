"""Training and evaluation: ``trainer`` (the train step, checkpoints and
the curriculum loop), ``summaries`` (host-side training summaries) and
``evaluation`` (full-image rendering loops and ``evaluate_scene``).

The trainer's entry points are re-exported here, as in the JAX package."""

from cross_attention_renderer_torch.train.trainer import (
    TrainConfig,
    TrainState,
    create_train_state,
    fit,
    make_loss_fn,
    make_optimizer,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    shard_state,
)

__all__ = ['TrainConfig', 'TrainState', 'create_train_state', 'fit',
           'make_loss_fn', 'make_optimizer', 'make_train_step',
           'restore_checkpoint', 'save_checkpoint', 'shard_state']
