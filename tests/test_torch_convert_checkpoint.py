"""The port's own converter of the upstream checkpoint
(``cross_attention_renderer_torch/tools/convert_checkpoint.py``), on the
CPU.

* On a full upstream-layout state dict (the DPT hybrid, 12 ViT blocks,
  ResNet (3, 4, 9), every head), made from a seed by the inverse of the
  mapping in tests/torch_checkpoint_cases.py, its output equals the JAX
  repository's ``tools/convert_checkpoint.py`` followed by
  ``params_from_jax``, key for key and bit for bit, and holds every key of
  the port's model.
* The golden fixtures (the reference torch model's weights and outputs)
  load through it and render to the reference outputs at
  tests/torch_parity.py's tolerances, at V = 2 and V = 3.
* The CLI round trip: an upstream ``.pth`` -> the tool -> ``--checkpoint
  _path``'s ``restore_params``, strict, gives the weights back; the
  unmapped keys are printed.
* The module imports no JAX and nothing of the JAX repository.

The upstream weights are not in the repository: nothing here needs them.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from cross_attention_renderer_torch.cli.common import restore_params
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.tools import convert_checkpoint as CC
from cross_attention_renderer_torch.train.trainer import (TrainConfig,
                                                          create_train_state)
from torch_checkpoint_cases import upstream_state_dict
from torch_parity import ROOT, assert_close, golden_fixture_model

sys.path.insert(0, str(ROOT))
from tools import convert_checkpoint as JCC  # noqa: E402

def _shapes(model) -> dict:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_full_upstream_state_dict_matches_the_jax_tool():
    """The flagship's full state dict (DPT hybrid, 12 blocks, (3, 4, 9)):
    the port's converter equals the JAX tool + ``params_from_jax`` key for
    key and bit for bit, and has every key of the model."""
    shapes = _shapes(CrossAttentionRenderer(device='meta'))
    sd = upstream_state_dict(shapes, seed=0)
    got, unmapped = CC._convert(sd, 2, 12, (3, 4, 9))
    assert set(got) == set(shapes) and unmapped == []
    assert CC._depths(sd) == (12, (3, 4, 9))
    want = params_from_jax(JCC.convert_reference_state_dict(sd, n_view=2))
    assert set(got) == set(want)
    for key in sorted(got):
        assert got[key].dtype == torch.float32 and got[key].is_contiguous()
        assert torch.equal(got[key], want[key]), key
    assert not any(k.startswith('update_val_merge') for k in got)


def test_view_count_picks_the_heads_the_model_builds():
    """The upstream model builds the single-view merge and the multi-view
    fuse MLP both; a port model builds one of them, and the converter
    keeps the one it builds and leaves the other unmapped."""
    small = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=2,
                 vit_heads=2, resnet_layers=(1, 1, 1), device='meta')
    v2 = _shapes(CrossAttentionRenderer(n_view=2, **small))
    v1 = _shapes(CrossAttentionRenderer(n_view=1, **small))
    sd = upstream_state_dict({**v1, **v2}, seed=1)
    assert CC._depths(sd) == (2, (1, 1, 1))
    for n_view, shapes, absent in (
            (2, v2, ('update_val_merge',)),
            (1, v1, ('query_encode_latent', 'query_encode_latent_2'))):
        got, unmapped = CC._convert(sd, n_view, 2, (1, 1, 1))
        assert set(got) == set(shapes), n_view
        assert unmapped == sorted(f'{h}.{leaf}' for h in absent
                                  for leaf in ('bias', 'weight'))


@pytest.mark.parametrize('n_view,kw', [
    (2, {}), (3, dict(reference_exchange_compat=True))])
def test_golden_fixture_through_the_ports_converter(n_view, kw):
    """The reference torch model's fixture weights, converted by the port
    alone, render the fixture's outputs (tests/test_torch_renderer.py's
    and tests/test_torch_renderer_v3.py's tolerances)."""
    def convert(sd, n_view):
        return CC.convert_reference_state_dict(sd, n_view=n_view)

    d, model, scene, z, (B, V, R, P) = golden_fixture_model(
        n_view, convert=convert, **kw)
    with torch.no_grad():
        out = model(scene, z=z)
    assert_close('pixel_val', out['pixel_val'],
                 d['out_pixel_val'].reshape(B, V, R, P, 2), atol=1e-4)
    assert_close('at_wt', out['at_wt'], d['out_at_wt'].reshape(B, V, R, P),
                 atol=1e-4)
    assert_close('depth_ray', out['depth_ray'], d['out_depth_ray'],
                 atol=1e-3)
    assert_close('valid_mask', out['valid_mask'], d['out_valid_mask'],
                 atol=1e-6)
    assert_close('rgb', out['rgb'], d['out_rgb'].reshape(B, 1, R, 3),
                 atol=1e-3)


def test_cli_round_trip_restores_strictly(tmp_path, capsys):
    """``.pth`` ({'model': sd}, as training.py saves it) -> the tool ->
    ``restore_params`` (what ``--checkpoint_path`` calls), strict: the
    model holds the source weights; an extra upstream key is printed as
    unmapped."""
    small = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=2,
                 vit_heads=2, resnet_layers=(1, 1, 1), device='cpu')
    source = CrossAttentionRenderer(seed=3, **small)
    sd = upstream_state_dict(_shapes(source), seed=2)
    sd['encoder.pretrained.model.head.weight'] = np.zeros((4, 768),
                                                          np.float32)
    want = CC.convert_reference_state_dict(sd, n_view=2, vit_depth=2,
                                           resnet_layers=(1, 1, 1))
    pth = tmp_path / 'model.pth'
    torch.save({'model': {k: torch.from_numpy(v) for k, v in sd.items()},
                'epoch': 7}, pth)
    out = CC.main(['--torch_ckpt', str(pth), '--out',
                   str(tmp_path / 'params.pt'), '--views', '2'])
    printed = capsys.readouterr().out
    assert ('1 upstream keys left unmapped\n'
            '  encoder.pretrained.model.head.weight') in printed
    assert torch.load(out, weights_only=True)['step'] == 0
    model = CrossAttentionRenderer(seed=4, **small)
    restore_params(create_train_state(model, TrainConfig()), str(out))
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def test_converter_imports_no_jax():
    code = '''
import sys
import cross_attention_renderer_torch.tools.convert_checkpoint
bad = sorted(m for m in sys.modules if m.split('.')[0] in (
    'jax', 'jaxlib', 'flax', 'cross_attention_renderer_tpu', 'tools'))
assert not bad, bad
print('clean')
'''
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and 'clean' in res.stdout, res.stderr
