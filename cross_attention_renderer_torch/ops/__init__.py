"""Gather, epilogue, MLP and attention ops; all but the gather launch CUDA
kernels.

Import from the submodules: ``grid_sample``, ``gather_epilogue`` (kernels
K2 and K3), ``fused_mlp`` (kernel K9) and ``epipolar_attention`` (kernel
K1).
"""
