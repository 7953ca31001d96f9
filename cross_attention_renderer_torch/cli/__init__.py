"""Command-line entry points, run as
``python -m cross_attention_renderer_torch.cli.<name>``: ``train``,
``eval`` and ``render_traj`` (the JAX package's CLI of the same names), on
the card unless ``--device cpu`` is given. ``render_unposed`` waits for
the pose module (ROADMAP.md Queue A 8)."""
