"""The sizes the work files count with, from a configuration: the
pyramid's width F and levels, the latent's O, the attention's K and phi's
width and blocks follow from the configuration's encoder (``model``) as
the model derives them (the reference's own rules,
``reference/model.py``). The DPT's sizes (``ff``, ``w``, ``depth``) are
carried only where the configuration has them."""

from reference import model as ref

DPT_SIZES = (('ff', 'fusion_features'), ('w', 'vit_width'),
             ('depth', 'vit_depth'))


def sizes(cfg: dict) -> dict:
    H, W = cfg['image_size']
    V, P = cfg['n_view'], cfg['n_samples']
    s = {'H': H, 'W': W, 'V': V, 'P': P, 'R': H * W,
         'F': ref.pyramid_width(cfg), 'O': ref.latent_width(cfg),
         'K': ref.HIDDEN, 'phi_hidden': ref.PHI_HIDDEN,
         'phi_blocks': ref.PHI_BLOCKS}
    s.update({k: cfg[key] for k, key in DPT_SIZES if key in cfg})
    return s


def pyramid_bytes(cfg: dict, elem: int = 2) -> int:
    """One view's feature pyramid, every level of the configuration's
    encoder (for the DPT: H/4 and H/2 at fusion_features, H at 64
    channels)."""
    H, W = cfg['image_size']
    return elem * sum(H * W // (d * d) * ch
                      for ch, d in ref.pyramid_levels(cfg))
