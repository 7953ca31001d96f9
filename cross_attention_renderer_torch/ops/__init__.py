"""Gather, epilogue and attention ops; the last two launch CUDA kernels.

Import from the submodules: ``grid_sample``, ``gather_epilogue`` (kernel
K2) and ``epipolar_attention`` (kernel K1).
"""
