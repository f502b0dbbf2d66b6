"""Run-generator construction (counterpart of `psvo_tpu/utils/rng.py`).

Every entry point derives its root `torch.Generator` here, seeded with
`cfg.seed + salt`, so runs never touch PyTorch's global RNG. The streams
differ from `jax.random`'s for the same seed; tests that compare the two
packages hand both the same numpy-made noise instead.
"""

from __future__ import annotations

import torch


def run_generator(cfg, salt: int = 0, device="cuda") -> torch.Generator:
    """Root generator for a run on `device` (the card unless the caller asks
    for the CPU): seed + salt."""
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed + salt)
    return gen
