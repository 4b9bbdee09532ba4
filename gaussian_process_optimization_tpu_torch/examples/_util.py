"""Helpers shared by the example scripts and the gallery."""
import numpy as np
import torch


def generator(seed, device):
    """A torch generator on ``device`` seeded with ``seed``: the restart draws
    the reference takes from ``jax.random.PRNGKey(seed)``."""
    return torch.Generator(device=device).manual_seed(seed)


def to_numpy(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
