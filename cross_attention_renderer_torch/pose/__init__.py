"""Pose estimation for the unposed path: SuperPoint + SuperGlue or the
classical Harris + NCC frontend (PyTorch, on the card) and the five-point
RANSAC pose (numpy, on the host).

Port of ``cross_attention_renderer_tpu/pose``. Submodules keep their names
(``pose.superpoint.SuperPoint``); the host-pipeline helpers are re-exported
here, as in the JAX package.
"""

from cross_attention_renderer_torch.pose import (classical, essential,
                                                 superglue, superpoint,
                                                 unposed)
from cross_attention_renderer_torch.pose.classical import match_pair_classical
from cross_attention_renderer_torch.pose.unposed import (
    estimate_pose,
    match_pair,
    rotate_interpolate,
    unposed_scene,
)

__all__ = ['classical', 'essential', 'estimate_pose', 'match_pair',
           'match_pair_classical', 'rotate_interpolate', 'superglue',
           'superpoint', 'unposed', 'unposed_scene']
