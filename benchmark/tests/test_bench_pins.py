"""What the four cells read, pinned to the values the harness gave before
a configuration could name its encoder: every parameter's name, shape and
draw in order (a digest: ``make_weights`` draws from them alone), the
operations of an image and of a stage-1 train step, the exchange's and
the attention's work of an image, and the faults planted in the DPT."""

import hashlib
import json

import pytest

import calibrate
from harness import bench, spec
from reference import model as ref

WORK = spec.BENCH_DIR / 'work'
PINS = {
    're10k_v2': {
        'specs': ('fc5c3ea7937481a7189418e23ce59eebdc009e3563c96db43b838bd1'
                  'e0e0a50a', 448),
        'render_ops': 22210341437440.0, 'train_ops': 9498267942912.0,
        'exchange': (21051782201344.0, 7354125696.0),
        'attention': (14042529792.0, 11383341056.0)},
    'co3d_v3': {
        'specs': ('bfee06aa6961b0975fa9170491eb7a02d6933ced362b4120ec3796b3'
                  '199a8416', 448),
        'render_ops': 36768697430016.0, 'train_ops': 14873796329472.0,
        'exchange': (35370263642112.0, 8476341632.0),
        'attention': (15797846016.0, 12796821504.0)},
}
DPT_FAULTS = {
    'r50_branch': 'encoder.backbone.stage2_block8.norm3.GroupNorm_0',
    'vit_branch': 'encoder.vit.block6.mlp_fc2',
    'refinenet_branch': 'encoder.refinenet2.rcu1.conv2',
    'phi_branch': 'phi.block1.fc_1'}


@pytest.mark.parametrize('name', sorted(PINS))
def test_what_the_cells_read_is_unchanged(name):
    cfg = spec.read_json(spec.BENCH_DIR / 'configs' / f'{name}.json')
    train = spec.read_json(spec.BENCH_DIR / 'traffic' / 'train.json')
    pin = PINS[name]
    specs = ref.param_specs(cfg)
    assert (hashlib.sha256(json.dumps(specs).encode()).hexdigest(),
            len(specs)) == pin['specs']
    model = bench.load_module(WORK / 'model.py')
    assert model.render_ops(cfg) == pin['render_ops']
    assert model.train_ops(cfg, train) == pin['train_ops']
    for layer in ('exchange', 'attention'):
        assert bench.load_module(WORK / f'{layer}.py').work(cfg, 1) == pin[
            layer]
    assert calibrate.branch_faults(cfg) == {
        k: (f'{v}.weight', f'{v}.bias') for k, v in DPT_FAULTS.items()}
