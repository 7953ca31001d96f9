"""Training and evaluation: ``trainer`` (the train step, checkpoints and
the curriculum loop), ``summaries`` (host-side training summaries) and
``evaluation`` (full-image rendering loops and ``evaluate_scene``).

The trainer's entry points are re-exported here, as in the JAX package,
but for ``shard_state``: the port trains on one card and has no mesh."""

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
)

__all__ = ['TrainConfig', 'TrainState', 'create_train_state', 'fit',
           'make_loss_fn', 'make_optimizer', 'make_train_step',
           'restore_checkpoint', 'save_checkpoint']
