"""Inputs made from ``--seed``: corpus, vocabulary and weights. The same
seed gives the same inputs."""

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """Independent numpy stream ``stream`` of ``seed`` (any whole number)."""
    return np.random.default_rng([abs(int(seed)), stream])


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from (seed, stream)."""
    return int(np.random.SeedSequence([abs(int(seed)), stream]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


# streams of one seed
CORPUS, WEIGHTS = range(2)
