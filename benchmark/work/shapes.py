"""The sizes the work files count with, from a configuration: the
pyramid's width F, the latent's O, the attention's K and phi's width and
blocks follow from ``fusion_features`` as the model derives them (the
reference's own rules, ``reference/model.py``)."""

from reference import model as ref


def sizes(cfg: dict) -> dict:
    H, W = cfg['image_size']
    V, P = cfg['n_view'], cfg['n_samples']
    return {'H': H, 'W': W, 'V': V, 'P': P, 'R': H * W,
            'F': ref.pyramid_width(cfg), 'O': ref.latent_width(cfg),
            'K': ref.HIDDEN, 'ff': cfg['fusion_features'],
            'w': cfg['vit_width'], 'depth': cfg['vit_depth'],
            'phi_hidden': ref.PHI_HIDDEN, 'phi_blocks': ref.PHI_BLOCKS}


def pyramid_bytes(cfg: dict, elem: int = 2) -> int:
    """One view's feature pyramid: H/4 and H/2 at fusion_features, H at
    64 channels."""
    s = sizes(cfg)
    H, W, ff = s['H'], s['W'], s['ff']
    return elem * (H * W // 16 * ff + H * W // 4 * ff + H * W * 64)
