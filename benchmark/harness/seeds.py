"""Everything a run draws comes from ``--seed`` through :func:`sub_seed`,
one independent stream a purpose, so that the same seed gives the same
weights, scenes and samples whatever else the run does."""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` from the run's seed (any integer)."""
    digest = hashlib.sha256(f'{seed}/{purpose}'.encode()).digest()
    return int.from_bytes(digest[:8], 'little') & (2 ** 63 - 1)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                               purpose))
