"""The plain reference against the program's plain path on the CPU, at a
tiny size, in f32: the same weights and scenes give the same pyramid,
image and train steps."""

import pytest
import torch

from harness import bench, program, scenes, spec
from harness.seeds import generator
from harness.weights import make_weights
from reference import model as ref

CPU = torch.device('cpu')
shapes = bench.load_module(spec.BENCH_DIR / 'work' / 'shapes.py')


@pytest.mark.parametrize('n_view', [2, 3])
@pytest.mark.parametrize('model', ref.ENCODERS)
def test_render_matches_the_program(tiny, model, n_view):
    cfg = tiny(n_view, model)
    weights = make_weights(cfg, 2 ** 31 + 11, CPU)
    encode, render_image = program.render_entry(
        program.make_model(cfg, weights, CPU), cfg)
    # a wide shell of cameras: some rays leave every context view
    s = scenes.draw(generator(3, 'test', CPU), 2, n_view, 32, 32, None, CPU)
    s['query']['cam2world'][1, 0, :3, 3] *= 3.0
    z = encode(s)
    rgb, valid = render_image(s, z)
    with torch.no_grad():
        pyr = ref.encode(weights, cfg, s['context']['rgb'],
                         s['context']['cam2world'])
        rgb_r, valid_r = ref.render_blocks(weights, cfg, pyr, s, 300)
    H, W = cfg['image_size']
    assert [tuple(t.shape) for t in pyr] == [
        (2 * n_view, H // d, W // d, ch) for ch, d in ref.pyramid_levels(cfg)]
    assert len(z) == len(pyr)
    for a, b in zip(z, pyr):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(rgb.reshape(rgb_r.shape), rgb_r, rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(valid.reshape(valid_r.shape), valid_r)


def test_train_steps_match_the_program(tiny):
    cell = spec.cell('re10k_v2.train')
    cell.config = tiny(2)
    cell.traffic = dict(cell.traffic, batch=2, rays=16)
    d = bench.driver(cell)(cell, 5, CPU)
    d.setup(make_weights(cell.config, 5, CPU))
    got = d.program_outputs()
    want = d.reference(make_weights(cell.config, 5, CPU), ref.F32,
                       d.checked())
    assert got['losses'] == pytest.approx(want['losses'], rel=1e-5)
    for n, g in want['first_grad'].items():
        assert got['first_grad'][n] == pytest.approx(g, rel=1e-3, abs=1e-9)
    numbers = d.numbers(got, want)
    assert max(numbers.values()) < 1e-3


def _configurations():
    """Every configuration of ``BENCHMARK.json``, and the ResNet34 and the
    U-Net at 2 and 3 views with the flagship's other sizes and none of
    the DPT's keys."""
    out = [spec.read_json(spec.ROOT / c['file'])
           for c in spec.load_spec()['configs']]
    common = {k: out[0][k] for k in ('n_samples', 'image_size', 'dtype',
                                     'ray_blocks')}
    return out + [dict(common, model=model, n_view=n_view)
                  for model in ('resnet', 'unet') for n_view in (2, 3)]


@pytest.mark.parametrize('cfg', _configurations(),
                         ids=lambda c: f"{c['model']}-{c['n_view']}")
def test_parameters_are_the_programs(cfg):
    """Names and shapes of every parameter of every configuration and of
    each encoder, and the widths the work files count with, against the
    program's model."""
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    dpt = {}
    if cfg['model'] == 'midas_vit':
        dpt = dict(fusion_features=cfg['fusion_features'],
                   vit_width=cfg['vit_width'], vit_depth=cfg['vit_depth'],
                   vit_heads=cfg['vit_heads'],
                   resnet_layers=tuple(cfg['resnet_layers']))
    with torch.device('meta'):
        m = CrossAttentionRenderer(
            n_view=cfg['n_view'], npoints=cfg['n_samples'],
            model=cfg['model'], dtype=torch.bfloat16, device='meta', **dpt)
    have = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    want = {n: s for n, s, _ in ref.param_specs(cfg)}
    assert have == want
    s = shapes.sizes(cfg)
    assert have['query_encode_latent.kernel'] == (s['F'] + 3, s['F'])
    assert have['latent_value.kernel'] == (s['V'] * s['O'], s['O'])
    assert have['key_map_2.kernel'] == (s['K'], s['K'])
    assert have['phi.lin_in.weight'][0] == s['phi_hidden']
    assert s['phi_blocks'] == sum(
        k.endswith('fc_0.weight') for k in have if k.startswith('phi.'))


def test_weights_follow_the_seed():
    cfg = {'model': 'midas_vit', 'n_view': 2, 'fusion_features': 32,
           'vit_width': 64, 'vit_depth': 1, 'resnet_layers': [1, 1, 1],
           'pretrain_grid': 14}
    a = make_weights(cfg, 2 ** 33 + 1, CPU)
    b = make_weights(cfg, 2 ** 33 + 1, CPU)
    c = make_weights(cfg, 2 ** 33 + 2, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['phi.lin_out.weight'], c['phi.lin_out.weight'])
    assert a['phi.block2.fc_1.weight'].abs().sum() > 0


def test_fp8_numerics_round_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    fp8 = ref.Numerics('fp8').q(x)
    bf16 = x.to(torch.bfloat16).float()
    assert (fp8 - x).abs().mean() > 8 * (bf16 - x).abs().mean()


@pytest.mark.parametrize('model', ['resnet', 'unet'])
def test_the_encoders_draws(model):
    """ResNet34's blocks end their residual branch with their second norm,
    drawn as such; the U-Net has no branch: every product there is drawn
    by its fan-in."""
    draws = {n: d for n, _, d in ref.param_specs({'model': model,
                                                  'n_view': 2})
             if n.startswith('encoder.')}
    if model == 'resnet':
        assert {n for n, d in draws.items() if d == 'branch_scale'} == {
            f'{p}.norm2.weight' for p, *_ in ref.resnet34_blocks()}
    else:
        assert {d for n, d in draws.items() if n.endswith('.weight')} == {
            'fan_in'}


@pytest.mark.parametrize('model', ref.ENCODERS)
def test_every_product_of_the_encoder_takes_the_numerics(tiny, model):
    """Each conv and dense weight of the encoder passes ``nx.q``, so the
    control's fp8 rounds every product of each encoder."""
    cfg = tiny(2, model)
    weights = make_weights(cfg, 2 ** 31 + 5, CPU)
    seen = set()

    class Recording(ref.Numerics):
        def q(self, x):
            seen.add(id(x))
            return x

    s = scenes.draw(generator(4, 'test', CPU), 1, 2, 32, 32, None, CPU)
    with torch.no_grad():
        ref.encode(weights, cfg, s['context']['rgb'],
                   s['context']['cam2world'], Recording())
    products = {n for n, t in weights.items() if n.endswith('.weight')
                and t.dim() >= 2 and not n.startswith(('phi.', 'query'))}
    standardised = {n for n in products if n.startswith('encoder.backbone')}
    assert products - standardised
    assert {n for n in products - standardised
            if id(weights[n]) not in seen} == set()


def test_an_unknown_encoder_is_refused_by_name(tiny):
    """Every place that reads the configuration's encoder refuses one the
    benchmark does not know, naming the three it knows, and a run stops
    at set-up: nothing counts the DPT's work for it."""
    import calibrate
    cfg = dict(tiny(2), model='vit_large')
    work = spec.BENCH_DIR / 'work'
    model = bench.load_module(work / 'model.py')
    for call in (ref.param_specs, ref.pyramid_width, shapes.sizes,
                 shapes.pyramid_bytes, model.encode_ops, model.render_ops,
                 calibrate.branch_faults,
                 lambda c: make_weights(c, 1, CPU),
                 lambda c: bench.load_module(work / 'exchange.py').work(c, 1)):
        with pytest.raises(ValueError, match='midas_vit, resnet, unet'):
            call(cfg)
    cell = spec.cell('re10k_v2.scenes')
    cell.config = cfg
    with pytest.raises(ValueError, match="'vit_large'"):
        bench.run(cell, 3, 0.1, False, CPU, 0.0)
