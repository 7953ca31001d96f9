"""The data layer: synthetic posed scenes (``synthetic``), the RealEstate10K,
ACID and CO3D-v2 loaders (``realestate``, ``acid``, ``co3d``), the native
frame decoder's bindings (``native_loader``) and the downloader
(``download``)."""

from cross_attention_renderer_torch.data.synthetic import make_scene

__all__ = ['make_scene']
