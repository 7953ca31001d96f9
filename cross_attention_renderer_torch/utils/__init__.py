"""Image utilities, metrics, profiling and ``params_io`` (flat ``.npz``
parameter files)."""

from cross_attention_renderer_torch.utils.image import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    normalize_imagenet,
    resize_bilinear,
    upsample2x_align_corners,
)

__all__ = ['IMAGENET_MEAN', 'IMAGENET_STD', 'normalize_imagenet',
           'resize_bilinear', 'upsample2x_align_corners']
