"""The ``train`` traffic kind: the program's stage-1 step in a loop, each
step on a fresh batch of scenes drawn on the card from the seed and the
step's index (the data feed, inside the window as a loader's would be).

Set-up builds the one train state, drives it through the first
``check_steps`` steps (which warm every shape up) and hands that same
state to the window. Those steps' losses, the first gradient as the
optimizer took it (its first moment after one step over 1 - beta1) and
each parameter's change over them are what the reference follows.

Traffic keys: ``batch`` (scenes a step), ``rays`` (query rays a scene),
``check_steps``, ``trace_steps`` (the traced window's length).
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from harness import program, scenes
from harness.seeds import generator
from harness.tracing import profiled, span
from harness.weights import make_weights
from reference import model as ref


class Driver:
    unit = 'steps'

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.traffic = cell.config, cell.traffic

    def batch(self, step: int) -> dict:
        H, W = self.cfg['image_size']
        return scenes.draw(generator(self.seed, f'step/{step}', self.device),
                           int(self.traffic['batch']), self.cfg['n_view'], H,
                           W, int(self.traffic['rays']), self.device)

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # -- set-up ------------------------------------------------------------
    def setup(self, weights: dict) -> None:
        self.model = program.make_model(self.cfg, weights, self.device)
        self.state, self.step, tcfg = program.train_entry(self.model)
        if (tcfg.lr, tcfg.clip_norm) != (float(self.traffic['lr']),
                                         float(self.traffic['clip'])):
            raise ValueError(f'the traffic states lr {self.traffic["lr"]} '
                             f'and clip {self.traffic["clip"]}; the '
                             f'program steps with {tcfg.lr}, {tcfg.clip_norm}')
        self.beta1 = tcfg.beta1
        names = {id(p): n for n, p in self.model.named_parameters()}
        self.losses, self.first_grad = [], {}
        for s in range(int(self.traffic['check_steps'])):
            self.state, m = self.step(self.state, self.batch(s))
            self.losses.append(float(m['total_loss']))
            if s == 0:
                self.first_grad = {
                    n: float(t.norm()) / (1.0 - self.beta1)
                    for n, t in program.adam_first_moments(self.state,
                                                           names).items()}
        start = make_weights(self.cfg, self.seed, self.device)
        self.change = {n: float((p.detach() - start[n]).norm())
                       for n, p in self.model.named_parameters()}
        del start
        self.next_step = int(self.traffic['check_steps'])
        self.step_losses = []
        self._sync()

    # -- the window --------------------------------------------------------
    def window(self, seconds: float, traced: bool) -> dict:
        """Steps until ``seconds`` have passed (traced: the traffic's
        ``trace_steps``), after those of any earlier window."""
        limit = int(self.traffic['trace_steps']) if traced else None
        with profiled(traced) as prof:
            with span('bench.window', traced):
                start = time.perf_counter()
                n = 0
                while True:
                    with span('bench.step', traced):
                        self.state, m = self.step(
                            self.state, self.batch(self.next_step))
                    self.next_step += 1
                    n += 1
                    self.step_losses.append(m['total_loss'])
                    if (limit is not None and n >= limit) or (
                            limit is None
                            and time.perf_counter() - start >= seconds):
                        break
                self._sync()
                end = time.perf_counter()
        self.trace = prof.trace
        return {'requests': n, 'units': n, 'window_s': end - start}

    def end_to_end(self, w: dict) -> dict:
        return {'train_steps_per_s': (w['units'] / w['window_s'], 'steps/s')}

    def failed(self) -> int:
        """Steps whose loss is not finite."""
        if not self.step_losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.step_losses))).sum())

    # -- the check ---------------------------------------------------------
    def checked(self) -> list[int]:
        return list(range(int(self.traffic['check_steps'])))

    def release(self, keep: list[int]) -> None:
        del self.model, self.state, self.step, self.step_losses
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def program_outputs(self) -> dict:
        return {'losses': self.losses, 'first_grad': self.first_grad,
                'change': self.change}

    def reference(self, weights: dict, numerics, keep: list[int],
                  batch_share: float = 1.0) -> dict:
        """The reference's losses, first clipped gradient and change over
        the same steps, from the same weights and batches: the clip to
        global norm ``clip`` and Adam written out. ``batch_share`` below 1
        keeps only that share of each batch (a planted fault)."""
        P = {n: w.detach().clone().requires_grad_(True)
             for n, w in weights.items()}
        start = {n: w.detach().clone() for n, w in P.items()}
        b1, b2, eps = self.beta1, 0.999, 1e-8
        lr, clip = float(self.traffic['lr']), float(self.traffic['clip'])
        m = {n: torch.zeros_like(p) for n, p in P.items()}
        v = {n: torch.zeros_like(p) for n, p in P.items()}
        losses, first = [], {}
        for s in keep:
            batch = self.batch(s)
            if batch_share < 1.0:
                n = max(1, int(scenes.count(batch) * batch_share))
                batch = scenes.take(batch, 0, n)
            loss = ref.image_loss(P, self.cfg, batch, numerics)
            grads = torch.autograd.grad(loss, list(P.values()),
                                        allow_unused=True)
            g = {n: (t if t is not None else torch.zeros_like(P[n]))
                 for n, t in zip(P, grads)}
            norm = math.sqrt(sum(float(t.square().sum()) for t in g.values()))
            scale = 1.0 if norm < clip else clip / norm
            with torch.no_grad():
                for n, p in P.items():
                    gn = g[n] * scale
                    m[n].mul_(b1).add_(gn, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(gn, gn, value=1 - b2)
                    t = s + 1
                    mh = m[n] / (1 - b1 ** t)
                    vh = v[n] / (1 - b2 ** t)
                    p.sub_(lr * mh / (vh.sqrt() + eps))
            losses.append(float(loss.detach()))
            if s == keep[0]:
                first = {n: float(t.norm()) * scale for n, t in g.items()}
        change = {n: float((P[n].detach() - start[n]).norm()) for n in P}
        return {'losses': losses, 'first_grad': first, 'change': change}

    def numbers(self, got: dict, want: dict) -> dict:
        """``grad_gap`` (the worst parameter), ``grad_median_gap`` (the
        median parameter) and ``update_gap`` (the worst): the gap between
        the norms of a parameter's first gradient (of its change over the
        steps) here and in the reference, over the larger of the
        reference's norm of that parameter and of the median parameter.
        Parameters whose reference gradient is under a thousandth of the
        median's move by round-off alone and are left out of the change.
        ``loss_gap``, the first step's |loss - reference| over the
        reference's, is for ``calibrate.py`` and has no limit: the control
        does not part from sound runs on it (PERF.md)."""
        def finite(x):
            return x if math.isfinite(x) else math.inf

        g_ref = want['first_grad']
        g_med = statistics.median(g_ref.values())
        grads = [finite(abs(got['first_grad'].get(n, 0.0) - r)
                        / max(r, g_med)) for n, r in g_ref.items()]
        moving = [n for n, r in g_ref.items() if r >= 1e-3 * g_med]
        c_ref = want['change']
        c_med = statistics.median(c_ref[n] for n in moving)
        update = max(finite(abs(got['change'][n] - c_ref[n])
                            / max(c_ref[n], c_med)) for n in moving)
        return {'grad_gap': max(grads),
                'grad_median_gap': statistics.median(grads),
                'update_gap': update,
                'loss_gap': finite(abs(got['losses'][0] - want['losses'][0])
                                   / abs(want['losses'][0]))}
