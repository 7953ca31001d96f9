"""Mesh parallelism: data, tensor and ray parallelism over a (data, model,
rays) mesh of ranks (:mod:`.mesh`); joining the process group, each rank's
rows and the collectives in :mod:`.distributed`."""

from cross_attention_renderer_torch.parallel.distributed import (
    global_scene,
    initialize,
    is_primary,
    make_global_mesh,
    process_batch_slice,
)
from cross_attention_renderer_torch.parallel.mesh import (
    make_mesh,
    param_shardings,
    param_spec,
    replicated,
    scene_shardings,
)

__all__ = ['global_scene', 'initialize', 'is_primary', 'make_global_mesh',
           'make_mesh', 'param_shardings', 'param_spec',
           'process_batch_slice', 'replicated', 'scene_shardings']
