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


@pytest.mark.parametrize('n_view', [2, 3])
def test_render_matches_the_program(tiny, n_view):
    cfg = tiny(n_view)
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


def test_parameters_are_the_programs():
    """Names and shapes of every parameter of every configuration, and the
    widths the work files count with, against the program's model."""
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    shapes = bench.load_module(spec.BENCH_DIR / 'work' / 'shapes.py')
    for c in spec.load_spec()['configs']:
        cfg = spec.read_json(spec.ROOT / c['file'])
        with torch.device('meta'):
            m = CrossAttentionRenderer(
                n_view=cfg['n_view'], npoints=cfg['n_samples'],
                model=cfg['model'], fusion_features=cfg['fusion_features'],
                vit_width=cfg['vit_width'], vit_depth=cfg['vit_depth'],
                vit_heads=cfg['vit_heads'],
                resnet_layers=tuple(cfg['resnet_layers']),
                dtype=torch.bfloat16, device='meta')
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
    cfg = {'n_view': 2, 'fusion_features': 32, 'vit_width': 64,
           'vit_depth': 1, 'resnet_layers': [1, 1, 1], 'pretrain_grid': 14}
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
