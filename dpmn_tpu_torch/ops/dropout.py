"""Dropout, DropPath and the random streams of one train step.

`F.dropout` takes no generator, so the masks here are drawn with
`torch.rand(..., generator=...)` from the step's own generators (`TrainRng`),
and a train step is a function of its seed.  The JAX package draws from
`jax.random`, which torch cannot reproduce: parity with it holds at rate 0,
where every function here is the identity and draws nothing.  On bf16 input
the output is bf16 and the kept elements are divided by the keep
probability rounded to bf16, as JAX's weakly typed `x / keep` does.
"""

from __future__ import annotations

import torch

from .torch_compat import weak
from .window_attention_train import SEED_BOUND


class TrainRng:
    """The random streams of one train step, seeded from the step's seed:
    `host`, a CPU generator, draws the attention-dropout seed of each K3 call
    (a host int, so no device sync); `device`, a generator on the step's
    device, draws the dropout and drop-path masks."""

    def __init__(self, seed: int, device):
        self.host = torch.Generator().manual_seed(seed)
        self.device = torch.Generator(device=device).manual_seed(seed)

    def kernel_seed(self) -> int:
        return int(torch.randint(0, SEED_BOUND, (1,), generator=self.host))


def _uniform(shape, x: torch.Tensor, rng: TrainRng) -> torch.Tensor:
    if rng is None:
        raise ValueError("a dropout rate above 0 in train mode needs the step's TrainRng")
    return torch.rand(shape, generator=rng.device, device=x.device)


def dropout(x: torch.Tensor, rate: float, rng: TrainRng) -> torch.Tensor:
    """flax nn.Dropout: keep each element with probability 1 - rate, kept
    elements scaled by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(_uniform(x.shape, x, rng) < keep, x / weak(keep, x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, rng: TrainRng) -> torch.Tensor:
    """DropPath (dpmn_tpu/models/pgrm.py:151-161): keep each sample with
    probability 1 - rate, kept samples scaled by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = (_uniform((x.shape[0],) + (1,) * (x.ndim - 1), x, rng) < keep).to(x.dtype)
    return x * mask / weak(keep, x.dtype)
