"""Chunkwise-parallel linear attention with gating (port of
``repro.models.linear_attn``).

One engine serves both recurrent families in the model zoo:
  * mLSTM (xLSTM): exponential input gate + sigmoid forget gate, running
    max-stabilizer, normalizer state  -> ``stabilize=True, normalize=True``
  * Mamba-2 / SSD (Hymba's SSM heads): scalar per-head decay from dt·A,
    no input gate / normalizer        -> ``stabilize=False``

Recurrence (per head):
    S_t = exp(ld_t) S_{t-1} + exp(li_t) k_t v_t^T
    n_t = exp(ld_t) n_{t-1} + exp(li_t) k_t
    y_t = q_t S_t   [ / max(|q_t n_t|, 1) when normalize ]

The chunked form computes, per chunk of width W, the intra-chunk part as
a decay-masked (W, W) attention and carries (S, n, m) across chunks. The
reference's ``lax.scan`` over chunks is a Python loop over the ``S // W``
chunks here. Everything inside is f32; the output is cast back to
``q.dtype``. ``decode_step`` is the single-token update, and
``reference_scan`` the step-by-step oracle built from it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG = -1e30


class LinState(NamedTuple):
    S: torch.Tensor      # (B, H, N, P)
    n: torch.Tensor      # (B, H, N)
    m: torch.Tensor      # (B, H) running stabilizer (log-space)


def init_state(B, H, N, P, dtype=torch.float32, device=None) -> LinState:
    return LinState(torch.zeros((B, H, N, P), dtype=dtype, device=device),
                    torch.zeros((B, H, N), dtype=dtype, device=device),
                    torch.zeros((B, H), dtype=dtype, device=device))


def _chunk(x, W):
    B, S = x.shape[:2]
    return x.reshape(B, S // W, W, *x.shape[2:])


def _max1(x):
    """``jnp.maximum(x, 1.0)``: a tie passes half the gradient, as JAX's
    ``max`` does (``clamp`` would pass all of it)."""
    return torch.maximum(x, x.new_ones(()))


def chunked(q, k, v, log_decay, log_in=None, *, chunk=128,
            normalize=False, stabilize=False,
            state: Optional[LinState] = None, return_state=False):
    """q,k: (B,S,H,N); v: (B,S,H,P); log_decay/log_in: (B,S,H)."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    W = min(chunk, S)
    assert S % W == 0
    if log_in is None:
        log_in = torch.zeros_like(log_decay)
    if state is None:
        state = init_state(B, H, N, P, device=q.device)

    qc, kc, vc = (_chunk(x.float(), W) for x in (q, k, v))
    ldc, lic = _chunk(log_decay.float(), W), _chunk(log_in.float(), W)
    tri = torch.tril(torch.ones((W, W), dtype=torch.bool, device=q.device))
    neg = torch.full((), NEG, device=q.device)
    Sst, nst, mst = state
    ys = []
    for c in range(S // W):
        qb, kb, vb = qc[:, c], kc[:, c], vc[:, c]      # (B,W,H,*)
        ldb, lib = ldc[:, c], lic[:, c]                 # (B,W,H)
        cum = torch.cumsum(ldb, dim=1)                  # inclusive
        if stabilize:
            # m_t = max(m_prev + cum_t, cum_t + cummax_{s<=t}(li_s - cum_s))
            inner = torch.cummax(lib - cum, dim=1).values
            m_t = torch.maximum(mst[:, None] + cum, cum + inner)
        else:
            m_t = torch.zeros_like(cum)
        # inter-chunk: y += exp(cum_t + m_prev - m_t) * q_t S_prev
        inter_w = torch.exp(cum + mst[:, None] - m_t)   # (B,W,H)
        y_inter = torch.einsum("bthn,bhnp->bthp", qb, Sst) * inter_w[..., None]
        d_inter = torch.einsum("bthn,bhn->bth", qb, nst) * inter_w
        # intra-chunk decay D(t,s) = exp(cum_t - cum_s + li_s - m_t),
        # masked above the diagonal *before* the exponential: there the
        # exponent can overflow, and exp(.) * 0 would be inf * 0 = NaN
        logD = (cum[:, :, None] - cum[:, None, :] + lib[:, None, :]
                - m_t[:, :, None])                      # (B,t,s,H)
        D = torch.exp(torch.where(tri[None, :, :, None], logD, neg))
        scores = torch.einsum("bthn,bshn->btsh", qb, kb) * D
        y = y_inter + torch.einsum("btsh,bshp->bthp", scores, vb)
        if normalize:
            den = d_inter + scores.sum(dim=2)
            y = y / _max1(torch.abs(den))[..., None]
        ys.append(y)
        # carry update (evaluated at t = W)
        cW, mW = cum[:, -1], m_t[:, -1]                 # (B,H)
        carry = torch.exp(cW + mst - mW)
        upd_w = torch.exp(cW[:, None] - cum + lib - mW[:, None])
        ku = kb * upd_w[..., None]
        Sst = (Sst * carry[..., None, None]
               + torch.einsum("bshn,bshp->bhnp", ku, vb))
        nst = nst * carry[..., None] + ku.sum(dim=1)
        mst = mW
    y = torch.stack(ys, dim=1).reshape(B, S, H, P).to(q.dtype)
    if return_state:
        return y, LinState(Sst, nst, mst)
    return y


def decode_step(state: LinState, q, k, v, log_decay, log_in=None, *,
                normalize=False, stabilize=False):
    """Single-token recurrent update. q,k: (B,H,N); v: (B,H,P); gates
    (B,H). Returns (state', y f32)."""
    if log_in is None:
        log_in = torch.zeros_like(log_decay)
    q, k, v = (x.float() for x in (q, k, v))
    ld, li = log_decay.float(), log_in.float()
    if stabilize:
        m_new = torch.maximum(state.m + ld, li)
    else:
        m_new = torch.zeros_like(state.m)
    fw = torch.exp(ld + state.m - m_new)
    iw = torch.exp(li - m_new)
    S = state.S * fw[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", k * iw[..., None], v)
    n = state.n * fw[..., None] + k * iw[..., None]
    y = torch.einsum("bhn,bhnp->bhp", q, S)
    if normalize:
        den = torch.einsum("bhn,bhn->bh", q, n)
        y = y / _max1(torch.abs(den))[..., None]
    return LinState(S, n, m_new), y.float()


def reference_scan(q, k, v, log_decay, log_in=None, *, normalize=False,
                   stabilize=False, state: Optional[LinState] = None):
    """Step-by-step oracle for tests (identical math, O(S) loop).
    Returns (y in q's dtype, final state)."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    if state is None:
        state = init_state(B, H, N, P, device=q.device)
    if log_in is None:
        log_in = torch.zeros_like(log_decay)
    ys = []
    for t in range(S):
        state, y = decode_step(state, q[:, t], k[:, t], v[:, t],
                               log_decay[:, t], log_in[:, t],
                               normalize=normalize, stabilize=stabilize)
        ys.append(y)
    return torch.stack(ys, dim=1).to(q.dtype), state
