"""Gather, epilogue, MLP and attention ops and the CUDA kernels behind them.

Import from the submodules: ``grid_sample`` (the packed-cell take path and
the corner math), ``gather_epilogue`` (kernels K2 and K3), ``fused_render``
(K4), ``sorted_gather`` (the sorted stream, K5 and K6), ``pallas_gather``
(K7 and the gather dispatch), ``experimental.banded_gather`` (K8),
``fused_mlp`` (K9) and ``epipolar_attention`` (K1).
"""
