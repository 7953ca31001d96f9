"""Training and evaluation: ``trainer`` (the train step, checkpoints and
the curriculum loop), ``summaries`` (host-side training summaries) and
``evaluation`` (full-image rendering loops and ``evaluate_scene``)."""
