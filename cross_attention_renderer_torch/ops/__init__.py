"""Gather, epilogue, MLP and attention ops and the CUDA kernels behind them.

The submodules: ``grid_sample`` (the packed-cell take path and the corner
math), ``gather_epilogue`` (kernels K2 and K3), ``fused_render`` (K4),
``sorted_gather`` (the sorted stream, K5 and K6), ``pallas_gather`` (K7 and
the gather dispatch), ``experimental.banded_gather`` (K8), ``fused_mlp``
(K9) and ``epipolar_attention`` (K1).

The JAX package's ``ops`` names are re-exported. Two of them are modules
here: ``epipolar_attention`` (as in the JAX package, whose K1 function is
``fused_epipolar_attention``) and ``grid_sample`` (a function in the JAX
package; here ``grid_sample.grid_sample``). Importing the package builds
no kernel.
"""

from cross_attention_renderer_torch.ops import grid_sample  # module
from cross_attention_renderer_torch.ops.grid_sample import (
    grid_sample_packed,
    grid_sample_pyramid,
    grid_sample_pyramid_packed,
    grid_sample_pyramid_parts,
    pack_cells,
    pack_pyramid,
)
from cross_attention_renderer_torch.ops.epipolar_attention import (
    epipolar_attention as fused_epipolar_attention,
    epipolar_attention_reference,
)
from cross_attention_renderer_torch.ops import epipolar_attention  # module
from cross_attention_renderer_torch.ops.pallas_gather import (
    grid_sample_auto,
    grid_sample_pallas,
)
from cross_attention_renderer_torch.ops.gather_epilogue import (
    fused_exchange_epilogue,
)
from cross_attention_renderer_torch.ops.fused_render import (
    fused_render_core,
)

__all__ = ['epipolar_attention', 'epipolar_attention_reference',
           'fused_epipolar_attention', 'fused_exchange_epilogue',
           'fused_render_core', 'grid_sample', 'grid_sample_auto',
           'grid_sample_packed', 'grid_sample_pallas',
           'grid_sample_pyramid', 'grid_sample_pyramid_packed',
           'grid_sample_pyramid_parts', 'pack_cells', 'pack_pyramid']
