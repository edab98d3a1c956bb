"""Model FLOPs of a training step and the bytes each kernel of LowDiff's
path needs, from a configuration file's sizes.

Model FLOPs per step = 6 N T + attention: N the non-embedding
parameters a token activates (the output head included; what a token
leaves idle, such as routed experts it does not pick, left out), T the
tokens of the step; both terms are the configuration's family's
(``chipbench/reference/families/``): 12 L d S T for full causal
attention, L the layers, d the model width, S the sequence length.
Recompute is not counted.

A kernel's bytes count each input byte read once and each output byte
written once, in the dtypes the kernel takes on the card:

* K1 ``topk_select``: reads the float32 corrected gradient, writes k
  float32 values and k int32 indices a block;
* K4 ``topk_apply``: reads and writes the parameters (their dtype) and
  both float32 moments, and reads the payload (float32 values, int32
  indices);
* K3 ``adam_tile_update``: reads the parameters, the gradient (in the
  parameters' dtype) and both moments, and writes the parameters and
  both moments.
"""
from __future__ import annotations

import math

from chipbench.reference.decoder import family, param_shapes
from chipbench.reference.optim import BLOCK, k_for

ITEMSIZE = {"float32": 4, "bfloat16": 2}


def leaves(m: dict):
    return [math.prod(shape) for shape, _ in param_shapes(m).values()]


def active_params(m: dict) -> int:
    """N: the parameters a token activates, but the input embedding."""
    return family(m).active_params(m)


def model_flops(m: dict, batch: int, seq: int) -> float:
    T = batch * seq
    return 6.0 * active_params(m) * T \
        + family(m).attention_flops(m, seq, T)


def _payload_bytes(m: dict, rho: float) -> int:
    """float32 values and int32 indices of a top-k payload."""
    k = k_for(rho, BLOCK)
    return sum(-(-n // BLOCK) * k * (4 + 4) for n in leaves(m))


def k1_bytes(m: dict, rho: float) -> int:
    return sum(n * 4 for n in leaves(m)) + _payload_bytes(m, rho)


def k4_bytes(m: dict, rho: float) -> int:
    p = ITEMSIZE[m["param_dtype"]]
    return 2 * sum(n * (p + 8) for n in leaves(m)) + _payload_bytes(m, rho)


def k3_bytes(m: dict) -> int:
    p = ITEMSIZE[m["param_dtype"]]
    return sum(n * (2 * p + p + 16) for n in leaves(m))
