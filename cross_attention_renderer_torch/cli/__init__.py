"""Command-line entry points, run as
``python -m cross_attention_renderer_torch.cli.<name>``: ``train``,
``eval``, ``render_traj`` and ``render_unposed`` (the JAX package's CLI of
the same names), on the card unless ``--device cpu`` is given."""
