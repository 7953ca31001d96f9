"""What the copy and bulk gathers need on the card, measured.

1. ``policies``: which cache policy (T1, T3, T4, T8). ``csrc/row_gather.cu``
   loads with an L2 ``evict_last`` policy and stores streaming
   (``st.global.cs``); the other three pairings of ``evict_last`` or
   ``L1::no_allocate`` alone with ``.cs`` or plain stores are built from
   patched copies of the source into ``build/``. ``index_select`` is timed
   before the variants touch the table, after them (on the lines they left
   marked) and after ``row_gather.release_l2``.
2. ``in_flight``: how many bytes in flight an SM a random row gather
   needs: the T1 gather (2 KB rows, 2^20 of them, 4 KB in flight a warp)
   at one or more blocks an SM of 2 to 8 warps, 8 to 128 KB an SM, on a
   table L2 cannot hold and on one it can.
3. ``short_rows``: how finely to spread a short gather: the bisect probes'
   2,048 rows with 8, 4, 2 or 1 rows in flight a warp (``fill_warps`` 0 to
   32).
4. ``bulk_warps``: the bulk gather's issuing warps a block, 4 or as many
   as shared memory holds (up to 8; T2, T5).
5. ``fill``: the block fill (T6's 2,048 rows of 128 int32) with
   ``st.global.cs`` stores (shipped) or plain ones (a patched copy of
   ``row_gather.cu``), each at 1, 2 and 4 chunks a thread and 2 or 4
   tiles an SM (``launch_plan``'s ``fill_depth``, ``fill_tiles``), and
   ``copy_`` from an expanded view, all in turns.
6. ``bilinear``: the bilinear gather (``csrc/bilinear_gather.cu``, K5-K8)
   on the inputs of the flagship V=2 sorted path's first ray block (its
   three self-stream and three cross-stream levels; the first is K8's
   case) and of the V=3 compat one-hot path's (K7): the cache policy
   (plain loads or ``evict_last`` ones, ``.cs`` or plain stores; patched
   copies of the source) and ``gather_plan``'s samples in flight a lane
   (``depth`` 1, 2, 4) and blocks an SM (one or two waves), beside
   ``embedding_bag`` (timed between CUDA events, as ``chip_smoke.py``
   times it), each turn on a table whose ``evict_last`` marks, where a
   variant left them, were cleared.

Every plan is ``row_gather.launch_plan``'s, at the keyword arguments the
study varies (``in_flight`` fixes the grid besides). Variants are timed in
the order A B C .. C B A, so that a drift of the card's clock falls on each
alike; a time is the mean of the turns, each timed from a table no earlier
turn left marked ``evict_last``. Every launch is checked bit for bit first.
Times are device times (``graph_ms``).

  python -m cross_attention_renderer_torch.tools.gather_study [study ...]
"""

from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import sys

from cross_attention_renderer_torch.ops import _build
from cross_attention_renderer_torch.ops.experimental import row_gather as RG
from cross_attention_renderer_torch.tools import _common as C
from cross_attention_renderer_torch.utils.profiling import cuda_ms, graph_ms

# the source's loads and stores, and what the variants put in their place
NO_ALLOCATE = ('.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, "\n      "[%4], %5;',
               '.v4.u32 {%0, %1, %2, %3}, "\n      "[%4];')
PLAIN_STORE = ('"st.global.cs.v4.u32', '"st.global.v4.u32')
# the shipped pairing first, so that it is timed last (A B C D D C B A)
# and index_select after the variants reads the lines it marked
POLICIES = {'evict_last + cs': [],
            'evict_last + plain': [PLAIN_STORE],
            'no_allocate + cs': [NO_ALLOCATE],
            'no_allocate + plain': [NO_ALLOCATE, PLAIN_STORE]}
# (label, table shape, M, copy_gather options)
CASES = (('T1 u1 (32768, 1024)', (32768, 1024), 1 << 20,
          dict(unroll=1, index='shared')),
         ('T1 u1 (8192, 1024)', (8192, 1024), 1 << 20,
          dict(unroll=1, index='shared')),
         ('T1 u8 (131072, 256)', (131072, 256), 1 << 20,
          dict(unroll=8, index='shared')),
         ('T3 u1 (32768, 1024)', (32768, 1024), 1 << 16, dict(unroll=1)),
         ('T3 u4 (8192, 1024)', (8192, 1024), 1 << 16, dict(unroll=4)),
         ('T4 u1 (16384, 16, 128)', (16384, 16, 128), 1 << 16,
          dict(unroll=1)),
         ('T8 (8192, 1024) 2048 rows', (8192, 1024), 2048,
          dict(index='shared')))


def build_variants(variants: dict, source: str = 'row_gather') -> dict:
    """Compiles a patched copy of ``csrc/<source>.cu`` a variant ({name:
    [(old, new), ...]}), all at once, into ``build/gather_study/``; the
    unpatched variant is the package's own build. Returns name -> library.
    Raises where a patch no longer matches the source."""
    text = (_build.CSRC_DIR / f'{source}.cu').read_text()
    out_dir = _build.BUILD_DIR / 'gather_study' / source
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for i, (name, patches) in enumerate(variants.items()):
        if not patches:
            libs[name] = _build.load(source)
            continue
        src = text
        for old, new in patches:
            if old not in src:
                raise RuntimeError(f'{name}: {source}.cu has changed')
            src = src.replace(old, new)
        cu, lib = out_dir / f'variant{i}.cu', out_dir / f'libvariant{i}.so'
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, '-I',
             str(_build.CSRC_DIR), '-o', str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def turns(label, variants, call, want, n: int, table) -> dict:
    """Times ``call(variant)`` for each variant in the order A B .. B A
    after checking it, each turn from a table no earlier turn left marked
    ``evict_last`` (``release_l2``); returns variant -> [ms, ms]."""
    times = {name: [] for name in variants}
    for name in list(variants) + list(reversed(variants)):
        C.check_exact(f'{label} {name}', call(name), want)
        RG.release_l2(table)
        times[name].append(graph_ms(lambda: call(name), n))
    return times


def report(label, times, lib_ms, bound_ms) -> list[dict]:
    records = []
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        print(f'{label:28s} {name:20s} {ms:8.4f} ms (turns '
              + ', '.join(f'{t:.4f}' for t in ts)
              + f')  {ms / lib_ms:5.3f}x index_select ({lib_ms:.4f})  '
              f'{100 * bound_ms / ms:5.1f}% of bound', flush=True)
        records.append({'case': label, 'variant': name, 'ms': ms,
                        'turns': ts, 'library_ms': lib_ms,
                        'bound_ms': bound_ms})
    return records


def library_ms(table, idx) -> float:
    import torch
    return graph_ms(lambda: torch.index_select(table, 0, idx),
                    C.calls_for(idx.shape[0]))


def case_inputs(shape, M, dev):
    """A case's table, indices and rows, and ``index_select``'s time on
    the table before any kernel touches it."""
    import torch
    table = C.random_table(shape, torch.bfloat16, 0, dev)
    idx = C.random_idx(shape[0], M, 0, dev)
    want = RG.row_gather_reference(table, idx)
    return table, idx, want, library_ms(table, idx)


def policies(dev) -> list[dict]:
    libs = build_variants(POLICIES)
    records = []
    try:
        for label, shape, M, kw in CASES:
            table, idx, want, lib_ms = case_inputs(shape, M, dev)

            def call(name):
                _build.use('row_gather', libs[name])
                return RG.copy_gather(table, idx, **kw)

            times = turns(label, POLICIES, call, want, C.calls_for(M),
                          table)
            records += report(label, times, lib_ms,
                              C.gather_bound(table, idx)[0])
            marked = library_ms(table, idx)
            RG.release_l2(table)
            released = library_ms(table, idx)
            print(f'{label:28s} index_select before the variants '
                  f'{lib_ms:.4f} ms, after them {marked:.4f} ms, after '
                  f'release_l2 {released:.4f} ms', flush=True)
            records.append({'case': label, 'library_ms': lib_ms,
                            'after_variants_ms': marked,
                            'after_release_ms': released})
            del table, idx, want
    finally:
        _build.use('row_gather', None)
    return records


# (blocks an SM, warps a block): 4 KB in flight a warp
IN_FLIGHT = ((1, 2), (1, 4), (1, 8), (2, 8), (4, 8))


def in_flight(dev) -> list[dict]:
    """The T1 gather (index from device memory, unroll 1) at a fixed grid
    of ``blocks x SMs`` blocks of ``warps`` warps, on the 67 MB and the
    16.8 MB tables."""
    sms = RG.sm_count(dev)
    records = []
    for hw in (32768, 8192):
        table, idx, want, _ = case_inputs((hw, 1024), 1 << 20, dev)
        M = idx.shape[0]
        bound_ms, _ = C.gather_bound(table, idx)
        for blocks, warps in IN_FLIGHT:
            plan = dataclasses.replace(
                RG.launch_plan('copy', M, 2048, sms, warps=warps),
                grid=blocks * sms)
            C.check_exact(f'in flight {blocks}x{warps}',
                          RG.run_plan(plan, table, idx), want)
            ms = graph_ms(lambda: RG.run_plan(plan, table, idx),
                          C.calls_for(M))
            kb = blocks * warps * 32 * RG.COPY_DEPTH * 16 / 1024
            print(f'in flight ({hw}, 1024): {blocks} block(s) an SM x '
                  f'{warps} warps = {kb:5.0f} KB an SM  {ms:8.4f} ms  '
                  f'{100 * bound_ms / ms:5.1f}% of bound', flush=True)
            records.append({'table': hw, 'blocks_per_sm': blocks,
                            'warps': warps, 'kb_per_sm': kb, 'ms': ms,
                            'bound_ms': bound_ms})
        RG.release_l2(table)
        del table, idx, want
    return records


# the bisect probes' short gathers: (label, table shape, dtype, options)
SHORT = (('T7 f32 (8192, 256)', (8192, 256), 'float32',
          dict(index='shared')),
         ('T8 bf16 (8192, 1024)', (8192, 1024), 'bfloat16',
          dict(index='shared')),
         ('T9 f32 (8192, 256) staged', (8192, 256), 'float32',
          dict(index='shared', stage=True)),
         ('T12 f32 (8192, 256)', (8192, 256), 'float32', dict()),
         ('T13 f32 (8192, 256)', (8192, 256), 'float32',
          dict(index='bulk')))


def short_rows(dev) -> list[dict]:
    """The bisect probes' 2,048-row gathers with ``fill_warps`` (warps an
    SM a short gather is spread over) from 0 (8 rows in flight a warp) to
    32, beside ``index_select``."""
    import torch
    sms = RG.sm_count(dev)
    records = []
    for label, shape, dtype, kw in SHORT:
        table = C.random_table(shape, getattr(torch, dtype), 2, dev)
        idx = torch.arange(2048, dtype=torch.int32, device=dev) % shape[0]
        want = RG.row_gather_reference(table, idx)
        lib_ms = graph_ms(lambda: torch.index_select(table, 0, idx), 512)
        row_bytes = table[0].numel() * table.element_size()
        for fill in (0, 4, 8, 16, 32):
            plan = RG.launch_plan('copy', 2048, row_bytes, sms,
                                  fill_warps=fill, **kw)
            C.check_exact(f'{label} fill {fill}',
                          RG.run_plan(plan, table, idx, **kw), want)
            ms = graph_ms(lambda: RG.run_plan(plan, table, idx, **kw), 512)
            print(f'{label:28s} fill_warps {fill:2d}: {plan.in_flight} rows '
                  f'a warp, {plan.grid} x {plan.warps} warps  '
                  f'{ms * 1e3:7.3f} us  {ms / lib_ms:5.3f}x index_select '
                  f'({lib_ms * 1e3:.3f} us)', flush=True)
            records.append({'case': label, 'fill_warps': fill,
                            'rows': plan.in_flight, 'grid': plan.grid,
                            'warps': plan.warps, 'ms': ms,
                            'library_ms': lib_ms})
        RG.release_l2(table)
    return records


BULK_CASES = (('T2 (32768, 1024)', (32768, 1024), 1 << 20),
              ('T2 (8192, 1024)', (8192, 1024), 1 << 20),
              ('T2 (131072, 256)', (131072, 256), 1 << 20),
              ('T5 (16384, 1024)', (16384, 1024), 1 << 16))


def bulk_warps(dev) -> list[dict]:
    """The bulk gather (window 16) with at most 4 issuing warps a block and
    with as many as shared memory holds."""
    sms = RG.sm_count(dev)
    records = []
    for label, shape, M in BULK_CASES:
        table, idx, want, lib_ms = case_inputs(shape, M, dev)
        rb = table[0].numel() * table.element_size()
        plans = {}
        for most in (4, RG.MAX_WARPS):
            plan = RG.launch_plan('bulk', M, rb, sms, window=16, warps=most)
            plans[f'{plan.warps} warps'] = plan
        times = turns(label, plans,
                      lambda name: RG.run_plan(plans[name], table, idx),
                      want, C.calls_for(M), table)
        records += report(label, times, lib_ms,
                          C.gather_bound(table, idx)[0])
        RG.release_l2(table)
        del table, idx, want
    return records


FILL_PLAIN = ('{ __stcs(p, v); }', '{ *p = v; }')
FILL_POLICIES = {'cs': [], 'plain': [FILL_PLAIN]}


def fill(dev) -> list[dict]:
    """T6's fill, ``.cs`` or plain stores at each ``fill_depth`` and
    ``fill_tiles``, and ``copy_`` from an expanded view, in turns A B .. B
    A."""
    import torch
    from cross_attention_renderer_torch.tools import micro_kgather_bisect
    M, bm, width = micro_kgather_bisect.M, micro_kgather_bisect.BM, 128
    sms = RG.sm_count(dev)
    idx = torch.arange(M, dtype=torch.int32, device=dev)
    want = RG.block_fill_reference(idx, bm, width)
    out = torch.empty_like(want)
    nb = M // bm
    bound_ms, _ = C.fill_bound(idx, bm, width)
    libs = build_variants(FILL_POLICIES)
    plans = {'copy_': (None, None)}
    plans.update({f'{pol} depth {d} tiles {t}': (pol, RG.launch_plan(
        'fill', M, width * 4, sms, fill_depth=d, fill_tiles=t))
        for pol in FILL_POLICIES for d in (1, 2, 4) for t in (2, 4)})
    records = []
    try:
        def call(name):
            pol, plan = plans[name]
            if pol is None:
                return out.view(nb, bm, width).copy_(
                    idx.view(nb, bm)[:, :1, None].expand(nb, bm, width)
                ).view(M, width)
            _build.use('row_gather', libs[pol])
            return RG.run_fill(plan, idx, bm, width)

        times = {name: [] for name in plans}
        for name in list(plans) + list(reversed(plans)):
            C.check_exact(f'fill {name}', call(name), want)
            times[name].append(graph_ms(lambda: call(name), 512))
    finally:
        _build.use('row_gather', None)
    lib_ms = sum(times['copy_']) / 2
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        plan = plans[name][1]
        shape = (f'grid {plan.grid} x {plan.warps} warps, tile {plan.tile}'
                 if plan else 'one PyTorch call')
        print(f'T6 fill {name:24s} {shape}: {ms * 1e3:7.3f} us (turns '
              + ', '.join(f'{t * 1e3:.3f}' for t in ts)
              + f')  {ms / lib_ms:5.3f}x copy_ ({lib_ms * 1e3:.3f} us)  '
              f'{100 * bound_ms / ms:5.1f}% of bound', flush=True)
        records.append({'variant': name, 'ms': ms, 'turns': ts,
                        'library_ms': lib_ms, 'bound_ms': bound_ms,
                        'plan': dataclasses.asdict(plan) if plan else None})
    return records


# the bilinear gather's loads and stores, and what the variants put there:
# loads with an L2 evict_last policy (made once, the asm being hoistable),
# plain stores
BILINEAR_EVICT_LAST = (
    'uint4 load_row(const uint4* p) { return __ldg(p); }',
    'uint4 load_row(const uint4* p) {\n'
    '  uint64_t policy;\n'
    '  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\\n"'
    ' : "=l"(policy));\n'
    '  uint4 v;\n'
    '  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, '
    '[%4], %5;\\n"\n'
    '      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)\n'
    '      : "l"(p), "l"(policy));\n'
    '  return v;\n'
    '}')
BILINEAR_PLAIN = ('__stcs(p, v);', '*p = v;')
BILINEAR_POLICIES = {'normal + cs': [],
                     'normal + plain': [BILINEAR_PLAIN],
                     'evict_last + cs': [BILINEAR_EVICT_LAST],
                     'evict_last + plain': [BILINEAR_EVICT_LAST,
                                            BILINEAR_PLAIN]}
# the main path's (kernel, entry point, output type) of each case set
ENTRIES = {'K5': ('resident_gather_bf16', 'bfloat16'),
           'K6': ('windowed_gather_bf16', 'float32'),
           'K7': ('onehot_gather_bf16', 'bfloat16'),
           'K8': ('banded_gather_bf16', 'bfloat16')}


def first_block_calls(dev, module, name, n_view=2, **kw):
    """The arguments of the first 6 calls of ``module.<name>`` as the
    flagship model (bf16, seed 0, model options ``kw``) renders the first
    8,192-ray block of the 256x256 ``make_scene(0)`` image."""
    import torch
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models import renderer as RM
    model = RM.CrossAttentionRenderer(dtype=torch.bfloat16, seed=0,
                                      device=dev, n_view=n_view, **kw).eval()
    scene = make_scene(0, n_view=n_view, H=256, W=256, n_rays=256 * 256,
                       full_image=True, device=dev)
    scene['query'] = dict(scene['query'],
                          uv=scene['query']['uv'][:, :, :8192])
    fn, seen = getattr(module, name), []

    def recorder(*args):
        if len(seen) < 6:
            seen.append(args)
        return fn(*args)

    setattr(module, name, recorder)
    try:
        with torch.inference_mode():
            model(scene)
    finally:
        setattr(module, name, fn)
    return seen


def bilinear_cases(dev) -> dict:
    """kernel -> [(label, table, idx, w)]: the V=2 sorted path's first
    block's six levels (K5; K6 on the three self-stream ones; K8 on the
    level-0 self-stream one) and the V=3 compat one-hot path's (K7)."""
    from cross_attention_renderer_torch.models import renderer as RM
    from cross_attention_renderer_torch.ops import pallas_gather as PG
    from cross_attention_renderer_torch.ops import sorted_gather as SG
    cases = []
    for fm, coords, image_id, mode in first_block_calls(
            dev, RM, 'grid_sample_sorted', npoints=64, sorted_stream=True):
        B, H, W, Ch = fm.shape
        idx, w = SG._corners_flat(H, W, coords.float(), image_id, mode)
        cases.append((fm.reshape(B * H * W, Ch), idx, w))
    onehot = []
    for fm, coords, mode in first_block_calls(
            dev, PG, 'grid_sample_pallas', n_view=3,
            reference_exchange_compat=True, fused_mlp=True, gather='onehot'):
        B, H, W, Ch = fm.shape
        idx, w = PG.flat_corners(fm, coords, mode)
        onehot.append((fm.reshape(B * H * W, Ch), idx, w))

    def named(key, items):
        return [(f'{key} {tuple(t.shape)} M={i.shape[0]}', t, i, w)
                for t, i, w in items]

    return {'K5': named('K5', cases), 'K6': named('K6', cases[:3]),
            'K7': named('K7', onehot), 'K8': named('K8', cases[:1])}


def bilinear(dev) -> list[dict]:
    """The bilinear gather's cache policies, then ``gather_plan``'s depth
    and blocks an SM (one wave of the blocks an SM holds, and two), on
    the main paths' first-block inputs; each variant
    checked against the shipped build's output first (bit for bit: a
    policy or a launch changes no arithmetic), then timed in turns A B ..
    B A from tables whose marks were cleared."""
    import torch
    import torch.nn.functional as F
    from cross_attention_renderer_torch.ops import sorted_gather as SG
    sms = SG.sm_count(dev)
    libs = build_variants(BILINEAR_POLICIES, 'bilinear_gather')
    records = []
    try:
        for key, cases in bilinear_cases(dev).items():
            entry, out_name = ENTRIES[key]
            out_dtype = getattr(torch, out_name)
            for label, table, idx, w in cases:
                M, Ch = idx.shape[0], table.shape[1]
                RG.release_l2(table)
                w_t = w.to(table.dtype)
                lib_ms = cuda_ms(lambda: F.embedding_bag(
                    idx, table, per_sample_weights=w_t, mode='sum'), 10)
                bound_ms, _ = C.bilinear_bound(table, idx, w, out_dtype)
                out = torch.empty((M, Ch), dtype=out_dtype, device=dev)

                def run(lib, plan):
                    _build.use('bilinear_gather', libs[lib])
                    SG.run_gather(entry, plan, table, idx, w, out)
                    return out

                shipped = SG.card_plan(dev, M, Ch, out_dtype)
                want = run('normal + cs', shipped).clone()
                variants = {name: (name, shipped)
                            for name in BILINEAR_POLICIES}
                # each depth at one wave of its resident blocks, and two
                for d in SG.GATHER_DEPTHS:
                    eff = min(d, SG.sample_lanes(Ch))
                    r = SG.resident_blocks(dev, eff, out_name == 'float32')
                    for b in (r, 2 * r):
                        variants[f'depth {eff}, {b} blocks/SM'] = (
                            'normal + cs',
                            SG.gather_plan(M, Ch, sms, b, depth=eff))

                def call(name):
                    return run(*variants[name])

                times = turns(label, variants, call, want, 10, table)
                for name, ts in times.items():
                    ms = sum(ts) / len(ts)
                    print(f'{label:36s} {name:24s} {ms:8.4f} ms (turns '
                          + ', '.join(f'{t:.4f}' for t in ts)
                          + f')  {ms / lib_ms:5.3f}x embedding_bag '
                          f'({lib_ms:.4f})  {100 * bound_ms / ms:5.1f}% of '
                          'bound', flush=True)
                    records.append({
                        'case': label, 'variant': name, 'ms': ms,
                        'turns': ts, 'library_ms': lib_ms,
                        'bound_ms': bound_ms,
                        'plan': dataclasses.asdict(variants[name][1])})
                RG.release_l2(table)
    finally:
        _build.use('bilinear_gather', None)
    return records


STUDIES = dict(policies=policies, in_flight=in_flight,
               short_rows=short_rows, bulk_warps=bulk_warps, fill=fill,
               bilinear=bilinear)


def run(dev=None, names=None) -> dict:
    dev = dev or C.device()
    return {name: STUDIES[name](dev) for name in names or STUDIES}


def main() -> None:
    run(names=sys.argv[1:] or None)


if __name__ == '__main__':
    main()
