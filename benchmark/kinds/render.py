"""The ``render`` traffic kind: one client in a closed loop. Each request
is new scenes from a pool drawn on the card in set-up (none repeats),
their encode and the whole query image through the program's image
renderer, ended by a synchronise.

Traffic keys: ``scenes_per_request`` (the batch of one call),
``pool_scenes`` (the pool; a window that would take more fails),
``check_requests`` (requests the reference checks: a sample drawn from
the seed among those completed, kept as the requests complete by
reservoir sampling, so that their pyramids are kept and no others) and
``trace_requests`` (the traced window's length).
"""

from __future__ import annotations

import math
import random
import statistics
import time

import torch

from harness import program, scenes
from harness.seeds import generator, sub_seed
from harness.tracing import profiled, span
from reference import model as ref

# rays a block of the f32 reference: small enough to fit beside the pool
REFERENCE_RAYS = 4096


class Driver:
    unit = 'images'

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.traffic = cell.config, cell.traffic
        self.batch = int(self.traffic['scenes_per_request'])
        self.done = 0
        self.sampler = random.Random(sub_seed(seed, 'check'))
        self.slots = int(self.traffic['check_requests'])
        self.kept_ids = []          # slot -> request

    # -- set-up ------------------------------------------------------------
    def setup(self, weights: dict) -> None:
        cfg, dev = self.cfg, self.device
        H, W = cfg['image_size']
        if dev.type == 'cuda':
            program.build_kernels(cfg, 'render')
        self.model = program.make_model(cfg, weights, dev)
        self.encode, self.render_image = program.render_entry(self.model, cfg)
        self.pool = scenes.draw(generator(self.seed, 'pool', dev),
                                int(self.traffic['pool_scenes']),
                                cfg['n_view'], H, W, None, dev)
        # Every request's image is copied into storage made here, so that
        # keeping them grows no memory inside the window.
        self.images = torch.empty(
            (scenes.count(self.pool) // self.batch, self.batch, 1, H * W, 3),
            device=dev)
        warm = scenes.draw(generator(self.seed, 'warm', dev), self.batch,
                           cfg['n_view'], H, W, None, dev)
        for _ in range(2):      # the second finds the allocator settled
            z = self._request(warm, None)
        # the pyramids of the checked requests, kept in storage made here
        self.pyramids = [torch.empty((self.slots,) + t.shape, dtype=t.dtype,
                                     device=dev) for t in z]

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _request(self, scene, slot, traced: bool = False, keep=None):
        """One request; its image goes to ``images[slot]``, its pyramid to
        check slot ``keep``."""
        with span('bench.request', traced):
            with span('bench.encode', traced):
                z = self.encode(scene)
            if keep is not None:
                for store, t in zip(self.pyramids, z):
                    store[keep].copy_(t)
            with span('bench.render', traced):
                rgb, _ = self.render_image(scene, z)
            if slot is not None:
                self.images[slot].copy_(rgb)
            self._sync()
        return z

    def _check_slot(self, i: int):
        """Reservoir sampling (Vitter's R) of ``check_requests`` among the
        requests: the slot request ``i`` takes, or None."""
        if i < self.slots:
            self.kept_ids.append(i)
            return i
        j = self.sampler.randrange(i + 1)
        if j < self.slots:
            self.kept_ids[j] = i
            return j
        return None

    def scene(self, i: int) -> dict:
        b = self.batch
        if (i + 1) * b > scenes.count(self.pool):
            raise RuntimeError(
                f'the pool of {scenes.count(self.pool)} scenes is spent at '
                f'request {i}: raise pool_scenes in the traffic file')
        return scenes.take(self.pool, i * b, (i + 1) * b)

    # -- the window --------------------------------------------------------
    def window(self, seconds: float, traced: bool) -> dict:
        """Requests until ``seconds`` have passed (traced: the traffic's
        ``trace_requests``), after those of any earlier window."""
        latencies = []
        limit = int(self.traffic['trace_requests']) if traced else None
        with profiled(traced) as prof:
            with span('bench.window', traced):
                start = time.perf_counter()
                while True:
                    i = self.done
                    scene = self.scene(i)
                    keep = self._check_slot(i)
                    t0 = time.perf_counter()
                    self._request(scene, i, traced, keep)
                    t1 = time.perf_counter()
                    latencies.append(t1 - t0)
                    self.done += 1
                    if (limit is not None and len(latencies) >= limit) or (
                            limit is None and t1 - start >= seconds):
                        break
        self.trace = prof.trace
        n = len(latencies)
        return {'requests': n, 'units': n * self.batch,
                'window_s': t1 - start, 'latencies_s': latencies}

    def end_to_end(self, w: dict) -> dict:
        lat = sorted(w['latencies_s'])
        p90 = (statistics.quantiles(lat, n=10, method='inclusive')[-1]
               if len(lat) > 1 else lat[0])
        return {'render_images_per_s': (w['units'] / w['window_s'], 'images/s'),
                'render_latency_p90_ms': (p90 * 1e3, 'ms')}

    def failed(self) -> int:
        """Requests whose image is not finite."""
        done = self.images[:self.done].flatten(1)
        return int((~torch.isfinite(done).all(dim=1)).sum())

    # -- the check ---------------------------------------------------------
    def checked(self) -> list[int]:
        return sorted(self.kept_ids)

    def release(self, keep: list[int]) -> None:
        """Frees the program and every output but those of ``keep``."""
        slot = {i: k for k, i in enumerate(self.kept_ids)}
        self.kept = {i: (self.images[i].clone(),
                         tuple(p[slot[i]] for p in self.pyramids))
                     for i in keep}
        del self.model, self.encode, self.render_image, self.images
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, weights: dict, numerics, keep: list[int]):
        """The reference's (rgb (B, R, 3), pyramid) of each kept
        request."""
        out = {}
        with torch.no_grad():
            for i in keep:
                s = self.scene(i)
                pyr = ref.encode(weights, self.cfg, s['context']['rgb'],
                                 s['context']['cam2world'], numerics)
                rgb, _ = ref.render_blocks(weights, self.cfg, pyr, s,
                                           REFERENCE_RAYS, numerics)
                out[i] = (rgb, pyr)
        return out

    def numbers(self, got: dict, want: dict) -> dict:
        """``image_err``: the worst checked image's RMS, over its rays and
        channels, of the difference of its RGB from the reference's (RGB
        units; rays no view sees are whited out on both sides, so the
        valid mask is in it). Not over the image's own RMS: that is set by
        the output's offset, which the rounding does not follow.
        ``pyramid_err``: the worst level of the checked requests' encoder
        pyramids, the RMS of its difference from the reference's over the
        reference's RMS (a fault in an encoder branch reaches the image
        damped; here it shows at its own size)."""
        def finite(x):
            return x if math.isfinite(x) else math.inf

        image, pyramid = 0.0, 0.0
        for i, (rgb_r, pyr_r) in want.items():
            rgb, pyr = got[i]
            rgb = rgb.reshape(rgb_r.shape).float()
            for b in range(rgb.shape[0]):
                err = float((rgb[b] - rgb_r[b]).square().mean().sqrt())
                image = max(image, finite(err))
            for a, r in zip(pyr, pyr_r):
                err = float((a.float() - r).square().mean().sqrt()
                            / r.square().mean().sqrt())
                pyramid = max(pyramid, finite(err))
        return {'image_err': image, 'pyramid_err': pyramid}

    def program_outputs(self) -> dict:
        return self.kept
