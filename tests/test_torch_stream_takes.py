"""The exchange streams' address math (``ops/stream_takes.py``) on the CPU:
the wrapper takes the plain version for CPU tensors, the plain version
keeps the layout the fused exchange kernels read (shapes, stream order,
``aux_layout``'s columns), and the kernel's wrapper refuses what its
kernel does not take before it reaches the card. The kernel itself is held
to the plain version bit for bit on the card (``test_torch_cuda.py``).
"""

import pytest
import torch

from torch_stream_cases import stream_case

from cross_attention_renderer_torch.geometry import rays as G
from cross_attention_renderer_torch.ops import _build
from cross_attention_renderer_torch.ops import stream_takes as ST
from cross_attention_renderer_torch.ops.gather_epilogue import aux_layout
from cross_attention_renderer_torch.ops.grid_sample import (
    cell_rows_and_slot_weights)

CASES = [(2, 3, torch.bfloat16), (3, 3, torch.bfloat16),
         (2, 4, torch.float32), (3, 4, torch.bfloat16)]


def _same(a, b):
    """Equal bit for bit (NaN included)."""
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    if a.dtype in bits:
        a, b = a.view(bits[a.dtype]), b.view(bits[b.dtype])
    return torch.equal(a, b)


def _args(case, dtype):
    return (case['level_hw'], case['pixel_val'], case['pt_views'],
            case['ctx_c2w'], case['ctx_intr'], case['H'], case['W'], dtype)


@pytest.mark.parametrize('V,levels,dtype', CASES)
def test_cpu_tensors_take_the_plain_version(monkeypatch, V, levels, dtype):
    """On CPU tensors: the plain version on the caller's exchange points,
    no launch and no library loaded."""
    case = stream_case(V, levels, B=2, R=5, P=4, seed=V * 10 + levels)
    monkeypatch.setattr(_build, 'load', lambda name: pytest.fail(name))
    seen = []

    def points(pt_views, c2w):
        seen.append(1)
        return ST.exchange_points(pt_views, c2w)

    before = ST.stream_takes.launches
    cells, aux = ST.stream_takes(*_args(case, dtype), points)
    assert seen == [1] and ST.stream_takes.launches == before
    pt_in = ST.exchange_points(case['pt_views'], case['ctx_c2w'])
    want_cells, want_aux = ST.stream_takes_reference(
        case['level_hw'], case['pixel_val'], pt_in, case['ctx_intr'],
        case['H'], case['W'], dtype)
    for got, want in zip(cells + tuple(aux), want_cells + tuple(want_aux)):
        assert _same(got, want)


@pytest.mark.parametrize('V,levels,dtype', CASES)
def test_stream_takes_layout(V, levels, dtype):
    """Per-level (V*M,) int32 cells, stream-major, and V aux arrays
    (M, aux_w) in the model type; stream 0 the self stream (view v's own
    point and segment, border padding), stream j >= 1 view v's j-th other
    view k ascending (the point in frame k projected with k's intrinsics
    on image row b*V + k, zeros padding); each level's slot weights in
    columns 4l..4l+3, tanh(pt/5) from aux_layout's column, zeros after."""
    B, R, P = 2, 5, 4
    case = stream_case(V, levels, B, R, P, seed=V + levels)
    cells, aux = ST.stream_takes(*_args(case, dtype))
    M = B * V * R * P
    t_col, width = aux_layout(levels)
    assert len(cells) == levels and len(aux) == V
    assert all(c.dtype == torch.int32 and tuple(c.shape) == (V * M,)
               for c in cells)
    assert all(a.dtype == dtype and tuple(a.shape) == (M, width)
               for a in aux)
    pt_in = ST.exchange_points(case['pt_views'], case['ctx_c2w'])
    pix = case['pixel_val'].reshape(B, V, R * P, 2)
    for s in range(V):
        for v in range(V):
            k = v if s == 0 else [o for o in range(V) if o != v][s - 1]
            pt = pt_in[:, k, v].reshape(B, R * P, 3)
            if s == 0:
                coords, mode = pix[:, v], 'border'
            else:
                proj = G.project_pinhole(pt, case['ctx_intr'][:, k])
                coords = G.pixel_to_ndc(proj[..., :2], case['H'], case['W'])
                mode = 'zeros'
            image = (torch.arange(B, dtype=torch.int32) * V + k)[:, None]
            rows = aux[s].reshape(B, V, R * P, width)[:, v]
            for l, hw in enumerate(case['level_hw']):
                c, w = cell_rows_and_slot_weights(hw, coords, mode,
                                                  image_id=image)
                got = cells[l][s * M:(s + 1) * M].reshape(B, V, R * P)[:, v]
                assert torch.equal(got, c)
                assert _same(rows[..., 4 * l:4 * l + 4].contiguous(),
                             w.to(dtype))
            assert _same(rows[..., t_col:t_col + 3].contiguous(),
                         torch.tanh(pt / 5.0).to(dtype))
            assert not rows[..., t_col + 3:].any()
    # the planted samples reach every branch: dead cross samples, sentinel
    # projections, border-clamped self samples
    assert any(bool((a[:, :4 * levels] == 0).all(-1).any()) for a in aux[1:])


@pytest.mark.parametrize('what', ['grad', 'f16 aux', '2 levels', '5 levels',
                                  'f64 points', 'one view', 'short coords'])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(what):
    """The kernel's wrapper checks its inputs before it builds or launches
    anything: inputs that require a gradient under grad mode (nothing
    differentiates through the address math), aux other than bf16 or f32,
    other than 3 or 4 levels, non-f32 geometry, one view, a wrong size."""
    case = stream_case(2, 3, B=1, R=3, P=4)
    args = list(_args(case, torch.bfloat16))
    if what == 'grad':
        args[2] = args[2].requires_grad_()
    elif what == 'f16 aux':
        args[7] = torch.float16
    elif what == '2 levels':
        args[0] = args[0][:2]
    elif what == '5 levels':
        args[0] = args[0] + ((2, 2), (2, 2))
    elif what == 'f64 points':
        args[2] = args[2].double()
    elif what == 'one view':
        one = stream_case(2, 3, B=1, R=3, P=4)
        args[1:5] = [one['pixel_val'][:1], one['pt_views'][:, :1],
                     one['ctx_c2w'][:, :1], one['ctx_intr'][:, :1]]
    else:
        args[1] = args[1][:, :-1]
    with pytest.raises(ValueError, match='stream_takes'):
        ST._launch(*args)


def test_grad_refusal_is_under_grad_mode_only():
    """Without grad mode, inputs that require a gradient pass the check
    (the refusal is about cutting a graph, not about the flag)."""
    case = stream_case(2, 3, B=1, R=3, P=4)
    args = list(_args(case, torch.float16))
    args[2] = args[2].requires_grad_()
    with torch.no_grad(), pytest.raises(ValueError, match='bf16 or f32'):
        ST._launch(*args)

