"""ACID (aerial coastline) dataset.

Port of ``cross_attention_renderer_tpu/data/acid.py``.

The reference's ``acid_dataio.py`` shares the npz+mat on-disk format and the
context-pair sampling constants with ``realestate10k_dataio.py``, so the
loaders subclass the RealEstate10K implementation — but two behavioral
deltas are real and carried here:

  * query frames are sampled STRICTLY BETWEEN the context pair with a
    16-frame margin (interpolation only, ``acid_dataio.py:366-374``),
    whereas RealEstate10K allows +-64-frame extrapolation past the span
    (``realestate10k_dataio.py:317-327``);
  * frames are resized to 256x455 unconditionally (``acid_dataio.py:387``),
    not only when the source is 360p.
"""

import numpy as np

from cross_attention_renderer_torch.data.realestate import (
    RealEstate10k,
    RealEstate10kVis,
    batch_iterator,
    trajectory_scene,
)

ACID_QUERY_MARGIN = 16  # acid_dataio.py:367-368


class ACID(RealEstate10k):
    """Training dataset for ACID. Ref: ``ACID`` (acid_dataio.py:193-503)."""

    always_resize = True  # acid_dataio.py:387 (resize regardless of source)

    def _query_bounds(self, id_feat: np.ndarray, n_frames: int):
        # interpolation-only: 16 frames inside the context span
        # (acid_dataio.py:366-374; the reference supports only 2 context
        # views here and asserts otherwise)
        return (id_feat.min() + ACID_QUERY_MARGIN,
                id_feat.max() - ACID_QUERY_MARGIN)


class ACIDVis(RealEstate10kVis):
    """Deterministic eval variant. Ref: ``ACIDVis`` (acid_dataio.py:504+);
    identical frame-selection rules to RealEstate10kVis."""

    always_resize = True


__all__ = ['ACID', 'ACIDVis', 'batch_iterator', 'trajectory_scene']
