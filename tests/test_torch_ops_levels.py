"""The 4-level mode of K2, K3 and K4 and the new K1 and K3 shapes, on the CPU.

* The plain versions of K2 (V=2), K3 (V=3) and K4 (the V=2 fused render),
  fed the port's 4-level aux rows (24 wide, tanh(pt/5) at column 16), against
  the JAX package's unfused exchange on the same weights and scene: K2's and
  K3's (jl, kv) against the outputs of JAX's ``latent_value`` and
  ``key_map_2`` under ``fused_epilogue=False``, K4's z against the latent
  JAX's decoder reads and its at_wt against JAX's, each within 1e-4 +
  1e-4 max(1, max |JAX|) in f32. The kernels' inputs are those the port's
  renderer hands them in one forward; JAX's intermediates are read with
  ``flax.linen.intercept_methods``.
* The plans the exchange core takes at the encoders' widths (ResNet34:
  F = H1 = 512, O = 256; U-Net: 960 and 480; DPT at V=4: K3 with S = 4),
  mirrored by ``core_plan``, and K1's launch at V*P = 192 and C = 512, 576
  and 960 (``attention_plan``); the refusals, with the shape in the
  message.
"""

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_tpu.models import (
    CrossAttentionRenderer as JaxRenderer)
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.models import renderer as RM
from cross_attention_renderer_torch.ops import epipolar_attention as EA
from cross_attention_renderer_torch.ops import fused_render as FR
from cross_attention_renderer_torch.ops import gather_epilogue as GE
from torch_parity import assert_close, random_flax_params

SMALL = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=1,
             vit_heads=2, resnet_layers=(1, 1, 1))
SCENE = dict(H=32, W=32, n_rays=16)
# (kernel, the renderer's module-level name of its wrapper, model kwargs)
KERNELS = {
    'K2-resnet': ('fused_exchange_epilogue', dict(model='resnet')),
    'K2-unet': ('fused_exchange_epilogue', dict(model='unet')),
    'K3-resnet': ('fused_exchange_epilogue_multi',
                  dict(model='resnet', n_view=3)),
    'K3-unet': ('fused_exchange_epilogue_multi', dict(model='unet',
                                                      n_view=3)),
    'K4-resnet': ('fused_render_core', dict(model='resnet',
                                            fused_render=True)),
    'K4-unet': ('fused_render_core', dict(model='unet', fused_render=True)),
}
PLAIN = {'fused_exchange_epilogue': GE.fused_exchange_epilogue_reference,
         'fused_exchange_epilogue_multi':
             GE.fused_exchange_epilogue_multi_reference,
         'fused_render_core': FR.fused_render_core_reference}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread (the tier-1 run puts six test workers on the
    machine's cores; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_unfused(kw, n_view):
    """Weights, JAX's outputs and the (args, output) of its modules'
    calls, by module name, under the unfused exchange."""
    model = JaxRenderer(fused_attention=False, fused_epilogue=False,
                        **SMALL, **kw)
    scene = jax_scene(3, n_view=n_view, **SCENE)
    params = random_flax_params(model, 0, scene)
    calls = {}

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == '__call__':
            calls.setdefault(context.module.name, []).append((args, out))
        return out

    with nn.intercept_methods(record):
        out = model.apply(params, scene)
    return params, out, calls


def _port_call(name, kw, n_view, params):
    """The arguments the port's renderer hands kernel ``name`` in one
    forward of its default route on the CPU."""
    model = RM.CrossAttentionRenderer(device='cpu', **SMALL, **kw)
    model.load_state_dict(params_from_jax(params), strict=True)
    fn, seen = getattr(RM, name), []

    def recorder(*args):
        seen.append(args)
        return fn(*args)

    setattr(RM, name, recorder)
    try:
        with torch.no_grad():
            model(make_scene(3, n_view=n_view, device='cpu', **SCENE))
    finally:
        setattr(RM, name, fn)
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize('key', KERNELS)
def test_four_level_plain_version_matches_jax_unfused(key):
    name, kw = KERNELS[key]
    jax_kw = {k: v for k, v in kw.items() if k != 'fused_render'}
    n_view = kw.get('n_view', 2)
    params, out, calls = _jax_unfused(jax_kw, n_view)
    args = _port_call(name, kw, n_view, params)
    tables, aux = args[0], args[2] if name.endswith('multi') else args[2:4]
    assert len(tables) == 4
    assert all(tuple(a.shape[1:]) == (24,) for a in aux)
    with torch.no_grad():
        got = PLAIN[name](*args)
    B, R, P = 1, SCENE['n_rays'], SMALL['npoints']
    ld = {'resnet': 512, 'unet': 960}[kw['model']] // 2
    if name == 'fused_render_core':
        z, at_wt = got
        phi_in = calls['phi'][0][0][0]              # [z_flat | coords]
        assert_close('z', z.numpy(), np.asarray(phi_in)[..., :ld],
                     atol=1e-4, rtol=1e-4)
        assert_close('at_wt', at_wt.numpy(), out['at_wt'], atol=1e-4,
                     rtol=1e-4)
        return
    jl, kv = got
    # V=2: latent_value runs once a view, on [self, cross] / [cross, self]
    want_jl = np.stack([np.asarray(o) for _, o in calls['latent_value']],
                       axis=1) if n_view == 2 else np.asarray(
                           calls['latent_value'][0][1])
    want_kv = np.asarray(calls['key_map_2'][0][1])
    M = B * n_view * R * P
    assert_close('jl', jl.numpy(), want_jl.reshape(M, ld), atol=1e-4,
                 rtol=1e-4)
    assert_close('kv', kv.numpy(), want_kv.reshape(M, -1), atol=1e-4,
                 rtol=1e-4)


def test_aux_layout():
    """Up to three levels the TPU kernels' 16-wide rows with tanh at 12;
    four levels 24 wide with tanh at 16."""
    assert [GE.aux_layout(n) for n in (1, 2, 3, 4)] == [(12, 16)] * 3 + [
        (16, 24)]


# (mode, S, F, H1, O, P, levels) -> the plan the core takes and its stage
# slots a ring: 'smem' where comb and the f rows fit beside three slots a
# ring, else 'resident' (comb in shared memory, the f rows in the scratch)
PLANS = {
    'K2 resnet': (('pair', 2, 512, 512, 256, 0, 4), ('smem', 3)),
    'K3 resnet V=3': (('streams', 3, 512, 512, 256, 0, 4), ('smem', 3)),
    'K4 resnet': (('render', 2, 512, 512, 256, 64, 4), ('smem', 4)),
    'K2 unet': (('pair', 2, 960, 960, 480, 0, 4), ('resident', 3)),
    'K3 unet V=3': (('streams', 3, 960, 960, 480, 0, 4), ('resident', 3)),
    'K4 unet': (('render', 2, 960, 960, 480, 64, 4), ('resident', 3)),
    'K3 dpt V=4': (('streams', 4, 576, 576, 288, 0, 3), ('resident', 4)),
    'K3 unet V=4': (('streams', 4, 960, 960, 480, 0, 4), ('resident', 3)),
}


@pytest.mark.parametrize('key', PLANS)
def test_core_plan_at_encoder_widths(key):
    (mode, S, F, H1, O, P, L), (plan, slots) = PLANS[key]
    got = GE.core_plan(mode, S, F, H1, O, 128, P, levels=L)
    assert (got.plan, got.slots) == (plan, slots)
    assert got.smem <= GE.SMEM_LIMIT
    GE.check_core_widths(key, mode, S, F, H1, O, 128, P, levels=L)
    # the 'resident' plan's f rows, and K4's ray rows, go to the scratch
    assert (got.scratch > 0) == (plan == 'resident' or mode == 'render')
    # three levels take the shared memory they took before the 4-level
    # mode: 1 KB less, for 8 fewer aux columns and one fewer cell row
    if L == 4:
        three = GE.core_plan(mode, S, F, H1, O, 128, P, levels=3)
        assert three.plan == plan
        assert got.smem - three.smem == 64 * 8 * 2 + 64 * 4


# The wide-tile rows K3 and K4 run on (mode, S, F, H1, O, P, levels): each
# takes the 'resident' plan with at least three stage slots a ring, in
# every element and table type (the types share their shared memory).
WIDE_TILE_ROWS = {
    'K3 S=4 (DPT V=4)': ('streams', 4, 576, 576, 288, 0, 3),
    'K3 S=5 (DPT V=5, also f32 and int8)': ('streams', 5, 576, 576, 288, 0,
                                            3),
    'K3 S=6 (DPT V=6)': ('streams', 6, 576, 576, 288, 0, 3),
    'K3 S=8 (DPT V=8)': ('streams', 8, 576, 576, 288, 0, 3),
    'K3 4-level ResNet34 S=5': ('streams', 5, 512, 512, 256, 0, 4),
    'K3 4-level U-Net V=3': ('streams', 3, 960, 960, 480, 0, 4),
    'K4 4-level U-Net': ('render', 2, 960, 960, 480, 64, 4),
    'K2 4-level U-Net': ('pair', 2, 960, 960, 480, 0, 4),
}


@pytest.mark.parametrize('key', WIDE_TILE_ROWS)
def test_wide_tile_rows_take_the_resident_plan(key):
    mode, S, F, H1, O, P, L = WIDE_TILE_ROWS[key]
    got = GE.core_plan(mode, S, F, H1, O, 128, P, levels=L)
    assert got.plan == 'resident' and got.slots >= 3
    # the scratch holds the f rows alone (S * O columns a tile), beside
    # K4's ray rows
    rays = 2 * P * (O + 128) * 2 if mode == 'render' else 0
    assert got.scratch == rays + -(-S * O // 64) * 8192


# (mode, S) at fusion_features ff (F = H1 = 2 ff + 64, O = ff + 32, K =
# 128, K4 at P = 64) -> (plan, stage slots a ring). K9 keeps 'smem' with
# fewer slots: its 'global' plan is slower (gather_epilogue.core_plan).
WIDE_FF_PLANS = {
    384: {('pair', 2): ('resident', 4), ('streams', 3): ('resident', 4),
          ('render', 2): ('resident', 4), ('mlp', 1): ('smem', 4)},
    512: {('pair', 2): ('resident', 3), ('streams', 3): ('resident', 3),
          ('render', 2): ('global', 4), ('mlp', 1): ('smem', 2)},
    768: {('pair', 2): ('global', 4), ('streams', 3): ('global', 4),
          ('render', 2): ('global', 4), ('mlp', 1): ('global', 4)},
}


@pytest.mark.parametrize('mode,S', [('pair', 2), ('streams', 3),
                                    ('render', 2), ('mlp', 1)])
@pytest.mark.parametrize('ff', sorted(WIDE_FF_PLANS))
def test_core_plan_at_wide_fusion_features(ff, mode, S):
    F, O = 2 * ff + 64, ff + 32
    got = GE.core_plan(mode, S, F, F, O, 128, 64)
    assert (got.plan, got.slots) == WIDE_FF_PLANS[ff][(mode, S)]
    GE.check_core_widths('k', mode, S, F, F, O, 128, 64)


@pytest.mark.parametrize('V,P,C,plan', [(4, 48, 288, (288, 4, 5376)),
                                        (1, 64, 576, (288, 2, 4864)),
                                        (1, 64, 960, (256, 1, 4096)),
                                        (1, 64, 512, (256, 2, 4352))])
def test_attention_plan_at_new_shapes(V, P, C, plan):
    assert EA.attention_plan(V, P, C) == plan


def test_refusals_name_the_shape():
    with pytest.raises(ValueError, match='V\\*P=12288'):
        EA.attention_plan(4, 3072, 288)
    with pytest.raises(ValueError, match='C=4100'):
        EA.attention_plan(2, 64, 4100)
    with pytest.raises(ValueError, match='H1 = 40000'):
        GE.check_core_widths('K3', 'streams', 4, 960, 40000, 480, 128,
                             levels=4)
    M, C = 64, 8
    tables = [torch.zeros((2, 4, 4, 4 * C)) for _ in range(5)]
    cells = [torch.zeros(2 * M, dtype=torch.int32) for _ in range(5)]
    aux = [torch.zeros((M, 24)) for _ in range(2)]
    params = (torch.zeros(5 * C + 3, 64), torch.zeros(64),
              torch.zeros(64, 32), torch.zeros(32), torch.zeros(64, 32),
              torch.zeros(32), torch.zeros(64, 128), torch.zeros(128),
              torch.zeros(128, 128), torch.zeros(128))
    with pytest.raises(ValueError, match='got 5'):
        GE._checked_args('K2', tables, cells, aux, params)
    with pytest.raises(ValueError, match=r'\(64, 24\)'):
        GE._checked_args('K2', tables[:4], cells[:4],
                         [torch.zeros((M, 16))] * 2,
                         (torch.zeros(4 * C + 3, 64),) + params[1:])


@pytest.mark.parametrize('name', ['epipolar_attention', 'gather_epilogue',
                                  'gather_epilogue_multi', 'fused_mlp',
                                  'fused_render', 'bilinear_gather',
                                  'row_gather', 'gather_epilogue_odd'])
def test_core_sources_build_with_split_compilation(name):
    """The exchange core's sources (and their odd-width builds) compile
    with nvcc's split compilation, the other kernels without; the flags
    are part of each library's name."""
    from cross_attention_renderer_torch.ops import _build
    source, extra = _build.source_flags(name)
    core = source in ('gather_epilogue', 'gather_epilogue_multi',
                      'fused_mlp', 'fused_render')
    assert (set(_build.SPLIT_FLAGS) <= set(extra)) == core
    assert ('-DCORE_ODD_OUTPUT=1' in extra) == name.endswith('_odd')
    assert (_build.CSRC_DIR / f'{source}.cu').exists()
