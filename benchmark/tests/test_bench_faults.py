"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped and the rest of a run is driven on
the CPU at a tiny size, under each cell's limits. A sound run at that
size comes out correct."""

import re
import time

import pytest
import torch

import calibrate
from harness import bench, program, scenes, spec

CPU = torch.device('cpu')


def tiny_cell(name, tiny, model='midas_vit'):
    cell = spec.cell(name)
    cell.config = tiny(cell.config['n_view'], model)
    if cell.traffic['kind'] == 'train':
        cell.traffic = dict(cell.traffic, batch=2, rays=16)
    else:
        cell.traffic = dict(cell.traffic, pool_scenes=32)
    return cell


def run(cell):
    return bench.run(cell, 2 ** 31 + 99, 0.5, False, CPU, time.perf_counter())


@pytest.mark.parametrize('name', ['re10k_v2.scenes', 'co3d_v3.scenes',
                                  're10k_v2.scenes_batch4',
                                  're10k_v2.train'])
def test_a_sound_run_is_correct(tiny, name):
    r = run(tiny_cell(name, tiny))
    assert r['correct'] and r['failed'] == 0, r['checks']


@pytest.mark.parametrize('name', ['re10k_v2.scenes', 'co3d_v3.scenes',
                                  're10k_v2.scenes_batch4'])
def test_an_altered_image_is_caught(tiny, name, monkeypatch):
    """One ray block's colours where another's belong."""
    entry = program.render_entry

    def broken(model, cfg):
        encode, render_image = entry(model, cfg)

        def render(scene, z):
            rgb, valid = render_image(scene, z)
            n = rgb.shape[2] // cfg['ray_blocks']
            rgb = rgb.clone()
            rgb[:, :, :n] = rgb[:, :, n:2 * n]
            return rgb, valid
        return encode, render

    monkeypatch.setattr(program, 'render_entry', broken)
    assert not run(tiny_cell(name, tiny))['correct']


@pytest.mark.parametrize('name', ['re10k_v2.scenes', 'co3d_v3.scenes',
                                  're10k_v2.scenes_batch4'])
@pytest.mark.parametrize('branch', [
    r'encoder\.refinenet2\.rcu1\.conv2\.',
    r'encoder\.vit\.block\d+\.mlp_fc2\.'])
def test_a_dropped_encoder_branch_is_caught(tiny, name, branch,
                                            monkeypatch):
    """Residual branches of the encoder left out of the program's forward
    (their last product zeroed after the weights load): one RefineNet
    unit's, every ViT block's MLP. At this size one ViT branch alone moves
    the pyramid by less than bf16 rounding does on the chip; there each
    single branch reads over the limit (PERF.md)."""
    make = program.make_model

    def broken(cfg, weights, device):
        model = make(cfg, weights, device)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if re.match(branch, n):
                    p.zero_()
        return model

    monkeypatch.setattr(program, 'make_model', broken)
    r = run(tiny_cell(name, tiny))
    assert not r['correct']
    c = r['checks']['pyramid_err']
    assert c['value'] > c['limit']


@pytest.mark.parametrize('name', ['re10k_v2.scenes', 'co3d_v3.scenes'])
@pytest.mark.parametrize('model, fault', [('resnet', 'resnet_branch'),
                                          ('unet', 'unet_level')])
def test_a_dropped_branch_or_level_of_another_encoder_is_caught(
        tiny, name, model, fault, monkeypatch):
    """The fault ``calibrate.branch_faults`` plants in a ResNet34 or U-Net
    configuration's encoder, planted in the program's forward instead:
    the last ResNet34 block's branch (its second norm zeroed), the
    U-Net's coarsest level (``down5`` zeroed)."""
    cell = tiny_cell(name, tiny, model)
    zeroed = calibrate.branch_faults(cell.config)[fault]
    make = program.make_model

    def broken(cfg, weights, device):
        model = make(cfg, weights, device)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in zeroed:
                    p.zero_()
        return model

    monkeypatch.setattr(program, 'make_model', broken)
    r = run(cell)
    assert not r['correct']
    c = r['checks']['pyramid_err']
    assert c['value'] > c['limit']


def test_a_step_that_leaves_the_state_unchanged_is_caught(tiny,
                                                          monkeypatch):
    entry = program.train_entry

    def broken(model):
        state, step, cfg = entry(model)

        def frozen(state, scene):
            with torch.no_grad():
                out = model(scene)
            loss = (scene['query']['rgb'] - out['rgb']).abs().mean()
            return state, {'total_loss': loss}
        return state, frozen, cfg

    monkeypatch.setattr(program, 'train_entry', broken)
    r = run(tiny_cell('re10k_v2.train', tiny))
    assert not r['correct']
    assert r['checks']['update_gap']['value'] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_caught(tiny, monkeypatch):
    entry = program.train_entry

    def broken(model):
        state, step, cfg = entry(model)

        def half(state, scene):
            n = scenes.count(scene) // 2
            return step(state, scenes.take(scene, 0, n))
        return state, half, cfg

    monkeypatch.setattr(program, 'train_entry', broken)
    assert not run(tiny_cell('re10k_v2.train', tiny))['correct']
