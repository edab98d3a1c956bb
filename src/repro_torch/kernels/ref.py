"""Plain-torch versions of the port's kernels.

Each repeats its kernel's arithmetic op for op, on (nb, block) tiles:
the CPU path runs them, the tests hold them against the reference's
Pallas kernels, and ``chip_smoke.py`` holds the CUDA kernels against them
on the card. They are not yardsticks of speed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def to_blocks(x: torch.Tensor, block: int):
    """Flatten and zero-pad to whole blocks: (nb, block) and the
    unpadded block count nb. (The reference also pads nb to its 8-row
    Pallas tile; the rows it adds are sliced off again, so nb and the
    zero tail are all that reach the results.)"""
    flat = x.reshape(-1)
    pad = (block - flat.numel() % block) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    xb = flat.reshape(-1, block)
    return xb, xb.shape[0]


def unblock(xb: torch.Tensor, shape, dtype=None) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= int(d)
    out = xb.reshape(-1)[:n].reshape(shape)
    return out if dtype is None else out.to(dtype)


def topk_select_ref(xb: torch.Tensor, k: int):
    """xb: (nb, block) -> (values (nb,k) in xb.dtype, int32 indices):
    k rounds of argmax (first maximum) on the f32 magnitude, the pick
    marked -1 so zero magnitudes are still taken in index order."""
    mag = torch.abs(xb.float())
    idxs = []
    for _ in range(k):
        i = torch.argmax(mag, dim=1, keepdim=True)      # (nb, 1)
        idxs.append(i)
        mag.scatter_(1, i, -1.0)
    idx = (torch.cat(idxs, dim=1) if idxs else
           torch.zeros((xb.shape[0], 0), dtype=torch.long, device=xb.device))
    return torch.gather(xb, 1, idx), idx.to(torch.int32)


def topk_scatter_ref(vals: torch.Tensor, idxs: torch.Tensor, block: int):
    """(nb, k) values + block-local indices -> dense (nb, block): added
    in f32 into zeros, cast to the values' dtype."""
    out = torch.zeros((vals.shape[0], block), dtype=torch.float32,
                      device=vals.device)
    out.scatter_add_(1, idxs.long(), vals.float())
    return out.to(vals.dtype)


def adam_tile_update_ref(p, g, mu, nu, hyper):
    """K3: hyper (1, 8) f32 = [lr, b1, b2, eps, c1, c2, -, -]; the moment
    complements 1-b1 / 1-b2 are computed in f32."""
    lr, b1, b2, eps, c1, c2 = (hyper[0, i] for i in range(6))
    pf, gf = p.float(), g.float()
    mu2 = b1 * mu + (1.0 - b1) * gf
    nu2 = b2 * nu + (1.0 - b2) * gf * gf
    step = lr * (mu2 / c1) / (torch.sqrt(nu2 / c2) + eps)
    return (pf - step).to(p.dtype), mu2, nu2


def adam_replay_update_ref(p, g, mu, nu, hyper):
    """K4's Adam tail: as :func:`adam_tile_update_ref` but the moment
    complements come pre-rounded from hyper slots 6/7, which matches
    ``optim.adam.adam_update``."""
    lr, b1, b2, eps, c1, c2, om1, om2 = (hyper[0, i] for i in range(8))
    pf, gf = p.float(), g.float()
    mu2 = b1 * mu + om1 * gf
    nu2 = b2 * nu + om2 * gf * gf
    step = lr * (mu2 / c1) / (torch.sqrt(nu2 / c2) + eps)
    return (pf - step).to(p.dtype), mu2, nu2


def topk_apply_ref(vals, idxs, p, mu, nu, hyper, *, block: int):
    """K4: scatter-decode a top-k wire payload (added in f32 into zeros)
    and apply one Adam step. p/mu/nu: (nb, block)."""
    g = torch.zeros((vals.shape[0], block), dtype=torch.float32,
                    device=vals.device)
    g.scatter_add_(1, idxs.long(), vals.float())
    return adam_replay_update_ref(p, g, mu, nu, hyper)
