"""Plain PyTorch gradient compression and optimizer: the yardstick for
LowDiff's compressor, its error feedback, Adam and the replay of a
differential chain. Imports nothing of the program.

* Blockwise top-k: the flattened tensor in blocks of ``block`` elements
  (the last one padded with zeros), each block keeping its k =
  ceil(rho * block) largest magnitudes, ties to the lowest index.
* Error feedback [Stich et al. 2018]: compress ``g + e``; the new ``e``
  is what the compressed tensor leaves out.
* Adam [Kingma and Ba 2015] with bias correction, moments in float32,
  the parameter updated in float32 and stored in its own dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BLOCK = 1024
#: Adam's first-moment decay: the program's default, which the traffic
#: does not set; a first moment after one step is (1 - B1) g
B1 = 0.9


def k_for(rho: float, block: int = BLOCK) -> int:
    return max(1, math.ceil(rho * block))


def topk(x: torch.Tensor, rho: float, block: int = BLOCK):
    """(values (nb, k) float32, indices (nb, k) int64) of ``x``."""
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)
    _, order = torch.sort(flat.abs(), dim=1, descending=True, stable=True)
    idx = order[:, :k_for(rho, block)]
    return torch.gather(flat, 1, idx), idx


def densify(values, indices, shape, block: int = BLOCK) -> torch.Tensor:
    """The dense float32 tensor of a blockwise top-k payload."""
    nb = values.shape[0]
    out = torch.zeros(nb, block, dtype=torch.float32, device=values.device)
    out.scatter_(1, indices.long(), values.float())
    n = math.prod(shape)
    return out.reshape(-1)[:n].reshape(shape)


def compress_ef(g: torch.Tensor, e: torch.Tensor, rho: float):
    """(dense compressed gradient, new residual) with error feedback."""
    corrected = g.float() + e
    v, i = topk(corrected, rho)
    dense = densify(v, i, corrected.shape)
    return dense, corrected - dense


class Adam:
    """Hyperparameters; ``dtype`` is the arithmetic's precision (float32,
    or bfloat16 for the control of a replay)."""

    def __init__(self, lr=1e-3, b1=B1, b2=0.999, eps=1e-8,
                 dtype=torch.float32):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.dtype = dtype

    def step(self, p, g, mu, nu, count: int):
        """(p', mu', nu') after step number ``count`` (1 for the first)."""
        dt = self.dtype
        g = g.to(dt)
        mu = self.b1 * mu.to(dt) + (1.0 - self.b1) * g
        nu = self.b2 * nu.to(dt) + (1.0 - self.b2) * g * g
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        upd = self.lr * (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
        return (p.to(dt) - upd).to(p.dtype), mu.float(), nu.float()
