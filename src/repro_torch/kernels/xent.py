"""The loss head's row kernels (``csrc/xent.cu``): ``xent_rows`` (each
row's logsumexp, target logit and masked loss from one read of the f32
logits) and ``xent_grad_split`` (the f32 logit gradient as its exact
three-term bf16 split, for the backward's tensor-core GEMMs). They
replace no TPU kernel: the JAX package leaves the head to XLA, and
``models/ops.py::_TensorCoreXent`` runs them between its GEMMs.

``logits`` is (R, ld) f32 with the vocabulary in its first ``n_valid``
columns and padding after (ld % 4 == 0). A tensor on the CPU goes to the
plain version in ``kernels.ref``; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref


def _check_rows(logits, targets, mask, n_valid: int) -> None:
    build.require_cuda(logits, "logits", dtypes=(torch.float32,))
    build.require_cuda(targets, "targets", dtypes=(torch.int32,), align=4)
    build.require_cuda(mask, "mask", dtypes=(torch.float32,), align=4)
    R, ld = logits.shape
    if ld % 4 or not 0 < n_valid <= ld:
        raise ValueError(f"logits (R, {ld}): ld must be a multiple of 4 "
                         f"and 0 < n_valid ({n_valid}) <= ld")
    if tuple(targets.shape) != (R,) or tuple(mask.shape) != (R,):
        raise ValueError(f"targets {tuple(targets.shape)} / mask "
                         f"{tuple(mask.shape)} must be ({R},)")


def xent_rows(logits: torch.Tensor, targets: torch.Tensor,
              mask: torch.Tensor, n_valid: int):
    """(lse, tgt, loss), each (R,) f32: per row the logsumexp of the
    first ``n_valid`` columns, the ``targets`` column, (lse - tgt) *
    mask."""
    if not logits.is_cuda:
        return ref.xent_rows_ref(logits, targets, mask, n_valid)
    _check_rows(logits, targets, mask, n_valid)
    R, ld = logits.shape
    lse, tgt, loss = (torch.empty((R,), dtype=torch.float32,
                                  device=logits.device) for _ in range(3))
    if R:
        fn = build.entry("xent", "xent_rows_f32")
        build.check(fn(logits.data_ptr(), targets.data_ptr(),
                       mask.data_ptr(), lse.data_ptr(), tgt.data_ptr(),
                       loss.data_ptr(), R, n_valid, ld,
                       build.stream_ptr(logits.device)), "xent_rows")
        build.LAUNCHES["xent_rows"] += 1
    return lse, tgt, loss


def xent_grad_split(logits: torch.Tensor, lse: torch.Tensor,
                    targets: torch.Tensor, mask: torch.Tensor,
                    dtot: torch.Tensor, n_valid: int) -> torch.Tensor:
    """The logit gradient g = dtot * mask * (softmax - onehot(target))
    of ``sum(loss) * dtot`` as (3R, ld) bf16 [hi; mid; lo] with hi + mid
    + lo == g in f32; zero in the padding columns. ``dtot`` is a
    one-element f32 tensor on the logits' device (read by the kernel)."""
    if not logits.is_cuda:
        return ref.xent_grad_split_ref(logits, lse, targets, mask, dtot,
                                       n_valid)
    _check_rows(logits, targets, mask, n_valid)
    R, ld = logits.shape
    build.require_cuda(lse, "lse", dtypes=(torch.float32,), align=4)
    build.require_cuda(dtot, "dtot", dtypes=(torch.float32,), align=4)
    if tuple(lse.shape) != (R,) or dtot.numel() != 1:
        raise ValueError(f"lse {tuple(lse.shape)} must be ({R},) and dtot "
                         f"one element")
    out = torch.empty((3 * R, ld), dtype=torch.bfloat16,
                      device=logits.device)
    if R:
        fn = build.entry("xent", "xent_grad_split_f32")
        build.check(fn(logits.data_ptr(), lse.data_ptr(),
                       targets.data_ptr(), mask.data_ptr(), dtot.data_ptr(),
                       out.data_ptr(), R, n_valid, ld,
                       build.stream_ptr(logits.device)), "xent_grad_split")
        build.LAUNCHES["xent_grad_split"] += 1
    return out
