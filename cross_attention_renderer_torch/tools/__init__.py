"""Measurement scripts of the port, run on the card as
``python -m cross_attention_renderer_torch.tools.<name>``: the row-gather
probes ``micro_kgather``, ``micro_kgather2``, ``micro_kgather3``,
``micro_kgather_bisect`` and ``micro_kgather_bisect2``, the Hopper
counterparts of the JAX repository's ``tools/`` scripts of the same names,
and ``bench_train`` (the flagship train step's time on both training
routes)."""
