"""Deterministic seeding (reference utils/util.py:16-25).

Counterpart of dpmn_tpu/utils/seed.py: seeds the host-side RNGs the data
pipeline uses (`random`, numpy's global state) and returns an explicit
generator.  Where the JAX package splits a key, the port draws from this
generator: the Trainer takes each train step's integer seed from it and the
rotation augmentation its angles.
"""

import os
import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator().manual_seed(seed)


def draw_seed(generator: torch.Generator) -> int:
    """One integer seed for a train step, drawn from `generator`."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
