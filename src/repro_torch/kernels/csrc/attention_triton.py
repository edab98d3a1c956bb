"""Blocked attention on the card's tensor cores, in Triton for sm_90a:
the forward (``attn_fwd_kernel``) and the backward's two kernels
(``attn_bwd_dq_kernel``, ``attn_bwd_dkdv_kernel``).

Replaces no TPU kernel: the JAX package's attention
(repro/models/ops.py:57) is a pure-jnp blocked online softmax that XLA
compiles. This is that algorithm as one kernel, in FlashAttention-2's
shape. It is loaded by ``kernels/build.py::triton_module`` inside the
first launch (``kernels/attention.py``), never at import: the CPU tests
import every module of the port on a machine without Triton.

Layout. q (B, Sq, H, D) already scaled, k (B, Sk, KV, D), v (B, Sk, KV,
DV), bf16, each with unit stride along its last dim (any other strides);
head h reads KV head h // G, G = H / KV. o, o32 (B, Sq, H, DV); lse and
delta (B, H, Sq) f32. D runs as DA + DB columns, both powers of two (MLA's
192 = 128 + 64: two products into one accumulator), or, where D is no
such sum, as DA >= D padded with masked loads; DV likewise padded to DVB.

Bound. The products run on tensor cores with bf16 operands and f32
accumulation: exact products and f32 sums, the precision of the f32
up-casts the plain body multiplies. At S 4096 every kernel is bound by
those products; at S 1024 and d 64 the forward is bound by its bytes
(q, k, v read, o and o32 written). The S x S score tile lives in
registers only: the forward keeps a running max m and sum l per row and
rescales its f32 accumulator; p = exp(s - m) is rounded to bf16 once,
against the running max of its key tile, for the p.v product.

Tiles. Each program of the forward holds one query tile of one head and
walks the key tiles [lo, hi) that hold a live key for some row of the
tile (tiles wholly above the diagonal or wholly outside the window are
skipped); the tiles in [f_lo, f_hi) are live for every row and run
without a mask. Query tiles launch longest first.

Backward (no float atomics, so every run gives the same bits):
* ``attn_bwd_dq_kernel``, one query tile of one head: delta = rowsum(g *
  o32) from the f32 output, stored for the other kernel; then over the
  live key tiles p = exp(s - lse), dp = g.v^T, ds = p (dp - delta) in
  f32, and dq += ds.k with ds as its exact three-term bf16 split (hi +
  mid + lo == ds bit for bit, so dq gets ds at f32 precision);
* ``attn_bwd_dkdv_kernel``, one key tile of one KV head: over the G query
  heads of its group and their live query tiles, dv += p^T.g with the
  normalised p as two bf16 terms (hi + mid: 16 significant bits, where
  one rounding of the normalised p would lose to the plain body's p,
  whose row maximum is exactly 1) and dk += ds^T.q with the three-term
  split of ds; dk and dv leave in bf16.
The launcher turns off fp contraction, so each product and sum rounds on
its own as in the plain version (``kernels/ref.py``).
"""
import triton
import triton.language as tl

NEG_INF = tl.constexpr(-1e30)


@triton.jit
def _load(base, rows, s_r, cols, n_r, n_c, MASK_R: tl.constexpr,
          MASK_C: tl.constexpr):
    """The (rows, cols) tile at ``base``, zero outside n_r x n_c where
    masked."""
    ptr = base + rows[:, None] * s_r + cols[None, :]
    if MASK_R:
        if MASK_C:
            x = tl.load(ptr, mask=(rows[:, None] < n_r) & (cols[None, :] < n_c),
                        other=0.0)
        else:
            x = tl.load(ptr, mask=rows[:, None] < n_r, other=0.0)
    else:
        if MASK_C:
            x = tl.load(ptr, mask=cols[None, :] < n_c, other=0.0)
        else:
            x = tl.load(ptr)
    return x


@triton.jit
def _store(base, x, rows, s_r, cols, n_r, n_c, MASK_C: tl.constexpr):
    ptr = base + rows[:, None] * s_r + cols[None, :]
    if MASK_C:
        tl.store(ptr, x, mask=(rows[:, None] < n_r) & (cols[None, :] < n_c))
    else:
        tl.store(ptr, x, mask=rows[:, None] < n_r)


@triton.jit
def _split3(x):
    """f32 x as bf16 (hi, mid, lo) with hi + mid + lo == x."""
    hi = x.to(tl.bfloat16)
    r = x - hi.to(tl.float32)
    mid = r.to(tl.bfloat16)
    lo = (r - mid.to(tl.float32)).to(tl.bfloat16)
    return hi, mid, lo


@triton.jit
def _live(qpos, kpos, Sq, Sk, window, CAUSAL: tl.constexpr,
          WINDOW: tl.constexpr):
    """Query qpos sees key kpos: both in range, kpos <= qpos if causal,
    kpos > qpos - window with a window."""
    ok = (qpos < Sq) & (kpos < Sk)
    if CAUSAL:
        ok = ok & (kpos <= qpos)
    if WINDOW:
        ok = ok & (kpos > qpos - window)
    return ok


@triton.jit
def _key_ranges(start_m, Sk, window, BLOCK_M: tl.constexpr,
                BLOCK_N: tl.constexpr, CAUSAL: tl.constexpr,
                WINDOW: tl.constexpr):
    """Key tiles of query rows [start_m, start_m + BLOCK_M): the live ones
    start at lo, lo + BLOCK_N, ... below hi; those in [f_lo, f_hi) are
    live for every row (``kernels/ref.py::attention_key_range``)."""
    lo = start_m * 0
    hi = lo + Sk
    f_lo = lo
    f_hi = (Sk // BLOCK_N) * BLOCK_N
    if CAUSAL:
        hi = tl.minimum(Sk, start_m + BLOCK_M)
        f_hi = (tl.minimum(Sk, start_m + 1) // BLOCK_N) * BLOCK_N
    if WINDOW:
        lo = (tl.maximum(start_m - window + 1, 0) // BLOCK_N) * BLOCK_N
        f_lo = tl.cdiv(tl.maximum(start_m + BLOCK_M - window, lo),
                       BLOCK_N) * BLOCK_N
    f_lo = tl.minimum(f_lo, hi)
    f_hi = tl.maximum(tl.minimum(f_hi, hi), f_lo)
    return lo, f_lo, f_hi, hi


@triton.jit
def _query_ranges(start_n, Sq, window, BLOCK_M: tl.constexpr,
                  BLOCK_N: tl.constexpr, CAUSAL: tl.constexpr,
                  WINDOW: tl.constexpr):
    """Query tiles of keys [start_n, start_n + BLOCK_N), as
    :func:`_key_ranges` (``kernels/ref.py::attention_query_range``)."""
    lo = start_n * 0
    hi = lo + Sq
    f_lo = lo
    f_hi = (Sq // BLOCK_M) * BLOCK_M
    if CAUSAL:
        lo = (start_n // BLOCK_M) * BLOCK_M
        f_lo = tl.cdiv(start_n + BLOCK_N - 1, BLOCK_M) * BLOCK_M
    if WINDOW:
        hi = tl.minimum(Sq, start_n + BLOCK_N - 1 + window)
        f_hi = (tl.minimum(Sq, start_n + window) // BLOCK_M) * BLOCK_M
    f_lo = tl.minimum(tl.maximum(f_lo, lo), hi)
    f_hi = tl.maximum(tl.minimum(f_hi, hi), f_lo)
    return lo, f_lo, f_hi, hi


# ------------------------------------------------------------- forward
@triton.jit
def _fwd_tiles(acc, l_i, m_i, qa, qb, k_base, v_base, s_kn, s_vn, offs_m,
               start, end, Sq, Sk, window,
               D: tl.constexpr, DA: tl.constexpr, DB: tl.constexpr,
               DV: tl.constexpr, DVB: tl.constexpr, BLOCK_N: tl.constexpr,
               MASK: tl.constexpr, CAUSAL: tl.constexpr,
               WINDOW: tl.constexpr):
    for n0 in range(start, end, BLOCK_N):
        offs_n = n0 + tl.arange(0, BLOCK_N)
        ka = _load(k_base, offs_n, s_kn, tl.arange(0, DA), Sk, D, MASK,
                   DA + DB != D)
        s = tl.dot(qa, tl.trans(ka))
        if DB > 0:
            kb = _load(k_base + DA, offs_n, s_kn, tl.arange(0, DB), Sk, D,
                       MASK, False)
            s = tl.dot(qb, tl.trans(kb), s)
        if MASK:
            ok = _live(offs_m[:, None], offs_n[None, :], Sq, Sk, window,
                       CAUSAL, WINDOW)
            s = tl.where(ok, s, NEG_INF)
        m_new = tl.maximum(m_i, tl.max(s, 1))
        p = tl.exp(s - m_new[:, None])
        alpha = tl.exp(m_i - m_new)
        l_i = l_i * alpha + tl.sum(p, 1)
        v = _load(v_base, offs_n, s_vn, tl.arange(0, DVB), Sk, DV, MASK,
                  DVB != DV)
        acc = tl.dot(p.to(tl.bfloat16), v, acc * alpha[:, None])
        m_i = m_new
    return acc, l_i, m_i


@triton.jit
def attn_fwd_kernel(Q, K, V, O, O32, LSE,
                    s_qb, s_qm, s_qh, s_kb, s_kn, s_kh, s_vb, s_vn, s_vh,
                    s_ob, s_om, s_oh, H, G, Sq, Sk, window,
                    D: tl.constexpr, DA: tl.constexpr, DB: tl.constexpr,
                    DV: tl.constexpr, DVB: tl.constexpr,
                    BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr,
                    CAUSAL: tl.constexpr, WINDOW: tl.constexpr,
                    STORE_F32: tl.constexpr):
    pid_m = tl.num_programs(0) - 1 - tl.program_id(0)
    bh = tl.program_id(1)
    b = (bh // H).to(tl.int64)
    h = bh % H
    start_m = pid_m * BLOCK_M
    offs_m = start_m + tl.arange(0, BLOCK_M)
    q_base = Q + b * s_qb + h * s_qh
    k_base = K + b * s_kb + (h // G) * s_kh
    v_base = V + b * s_vb + (h // G) * s_vh
    qa = _load(q_base, offs_m, s_qm, tl.arange(0, DA), Sq, D, True,
               DA + DB != D)
    qb = qa
    if DB > 0:
        qb = _load(q_base + DA, offs_m, s_qm, tl.arange(0, DB), Sq, D, True,
                   False)
    m_i = tl.full([BLOCK_M], NEG_INF, tl.float32)
    l_i = tl.zeros([BLOCK_M], tl.float32)
    acc = tl.zeros([BLOCK_M, DVB], tl.float32)
    lo, f_lo, f_hi, hi = _key_ranges(start_m, Sk, window, BLOCK_M, BLOCK_N,
                                     CAUSAL, WINDOW)
    acc, l_i, m_i = _fwd_tiles(acc, l_i, m_i, qa, qb, k_base, v_base, s_kn,
                               s_vn, offs_m, lo, f_lo, Sq, Sk, window, D, DA,
                               DB, DV, DVB, BLOCK_N, True, CAUSAL, WINDOW)
    acc, l_i, m_i = _fwd_tiles(acc, l_i, m_i, qa, qb, k_base, v_base, s_kn,
                               s_vn, offs_m, f_lo, f_hi, Sq, Sk, window, D,
                               DA, DB, DV, DVB, BLOCK_N, False, CAUSAL,
                               WINDOW)
    acc, l_i, m_i = _fwd_tiles(acc, l_i, m_i, qa, qb, k_base, v_base, s_kn,
                               s_vn, offs_m, f_hi, hi, Sq, Sk, window, D, DA,
                               DB, DV, DVB, BLOCK_N, True, CAUSAL, WINDOW)
    l_i = tl.maximum(l_i, 1e-20)
    o = tl.math.div_rn(acc, tl.broadcast_to(l_i[:, None], (BLOCK_M, DVB)))
    offs_dv = tl.arange(0, DVB)
    o_off = b * s_ob + h * s_oh
    _store(O + o_off, o.to(tl.bfloat16), offs_m, s_om, offs_dv, Sq, DV,
           DVB != DV)
    if STORE_F32:
        _store(O32 + o_off, o, offs_m, s_om, offs_dv, Sq, DV, DVB != DV)
    tl.store(LSE + bh.to(tl.int64) * Sq + offs_m, m_i + tl.log(l_i),
             mask=offs_m < Sq)


# ------------------------------------------------------------- backward
@triton.jit
def _dq_tiles(dqa, dqb, qa, qb, do, lse, delta, k_base, v_base, s_kn, s_vn,
              offs_m, start, end, Sq, Sk, window,
              D: tl.constexpr, DA: tl.constexpr, DB: tl.constexpr,
              DV: tl.constexpr, DVB: tl.constexpr, BLOCK_N: tl.constexpr,
              MASK: tl.constexpr, CAUSAL: tl.constexpr,
              WINDOW: tl.constexpr):
    for n0 in range(start, end, BLOCK_N):
        offs_n = n0 + tl.arange(0, BLOCK_N)
        ka = _load(k_base, offs_n, s_kn, tl.arange(0, DA), Sk, D, MASK,
                   DA + DB != D)
        s = tl.dot(qa, tl.trans(ka))
        if DB > 0:
            kb = _load(k_base + DA, offs_n, s_kn, tl.arange(0, DB), Sk, D,
                       MASK, False)
            s = tl.dot(qb, tl.trans(kb), s)
        p = tl.exp(s - lse[:, None])
        if MASK:
            ok = _live(offs_m[:, None], offs_n[None, :], Sq, Sk, window,
                       CAUSAL, WINDOW)
            p = tl.where(ok, p, 0.0)
        v = _load(v_base, offs_n, s_vn, tl.arange(0, DVB), Sk, DV, MASK,
                  DVB != DV)
        dp = tl.dot(do, tl.trans(v))
        hi, mid, lo = _split3(p * (dp - delta[:, None]))
        dqa = tl.dot(hi, ka, dqa)
        dqa = tl.dot(mid, ka, dqa)
        dqa = tl.dot(lo, ka, dqa)
        if DB > 0:
            dqb = tl.dot(hi, kb, dqb)
            dqb = tl.dot(mid, kb, dqb)
            dqb = tl.dot(lo, kb, dqb)
    return dqa, dqb


@triton.jit
def attn_bwd_dq_kernel(Q, K, V, DO, O32, LSE, DELTA, DQ,
                       s_qb, s_qm, s_qh, s_kb, s_kn, s_kh, s_vb, s_vn, s_vh,
                       s_ob, s_om, s_oh, H, G, Sq, Sk, window,
                       D: tl.constexpr, DA: tl.constexpr, DB: tl.constexpr,
                       DV: tl.constexpr, DVB: tl.constexpr,
                       BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr,
                       CAUSAL: tl.constexpr, WINDOW: tl.constexpr):
    pid_m = tl.num_programs(0) - 1 - tl.program_id(0)
    bh = tl.program_id(1)
    b = (bh // H).to(tl.int64)
    h = bh % H
    start_m = pid_m * BLOCK_M
    offs_m = start_m + tl.arange(0, BLOCK_M)
    q_base = Q + b * s_qb + h * s_qh
    k_base = K + b * s_kb + (h // G) * s_kh
    v_base = V + b * s_vb + (h // G) * s_vh
    o_off = b * s_ob + h * s_oh
    offs_dv = tl.arange(0, DVB)
    qa = _load(q_base, offs_m, s_qm, tl.arange(0, DA), Sq, D, True,
               DA + DB != D)
    qb = qa
    if DB > 0:
        qb = _load(q_base + DA, offs_m, s_qm, tl.arange(0, DB), Sq, D, True,
                   False)
    do = _load(DO + o_off, offs_m, s_om, offs_dv, Sq, DV, True, DVB != DV)
    o32 = _load(O32 + o_off, offs_m, s_om, offs_dv, Sq, DV, True, DVB != DV)
    delta = tl.sum(do.to(tl.float32) * o32, 1)
    row = bh.to(tl.int64) * Sq + offs_m
    tl.store(DELTA + row, delta, mask=offs_m < Sq)
    lse = tl.load(LSE + row, mask=offs_m < Sq, other=0.0)
    dqa = tl.zeros([BLOCK_M, DA], tl.float32)
    dqb = dqa
    if DB > 0:
        dqb = tl.zeros([BLOCK_M, DB], tl.float32)
    lo, f_lo, f_hi, hi = _key_ranges(start_m, Sk, window, BLOCK_M, BLOCK_N,
                                     CAUSAL, WINDOW)
    dqa, dqb = _dq_tiles(dqa, dqb, qa, qb, do, lse, delta, k_base, v_base,
                         s_kn, s_vn, offs_m, lo, f_lo, Sq, Sk, window, D, DA,
                         DB, DV, DVB, BLOCK_N, True, CAUSAL, WINDOW)
    dqa, dqb = _dq_tiles(dqa, dqb, qa, qb, do, lse, delta, k_base, v_base,
                         s_kn, s_vn, offs_m, f_lo, f_hi, Sq, Sk, window, D,
                         DA, DB, DV, DVB, BLOCK_N, False, CAUSAL, WINDOW)
    dqa, dqb = _dq_tiles(dqa, dqb, qa, qb, do, lse, delta, k_base, v_base,
                         s_kn, s_vn, offs_m, f_hi, hi, Sq, Sk, window, D, DA,
                         DB, DV, DVB, BLOCK_N, True, CAUSAL, WINDOW)
    # dq (B, Sq, H, D) contiguous
    dq_base = DQ + (b * Sq * H + h) * D
    _store(dq_base, dqa.to(tl.bfloat16), offs_m, H * D, tl.arange(0, DA),
           Sq, D, DA + DB != D)
    if DB > 0:
        _store(dq_base + DA, dqb.to(tl.bfloat16), offs_m, H * D,
               tl.arange(0, DB), Sq, D, False)


@triton.jit
def _dkdv_tiles(dka, dkb, dv, ka, kb, v, q_base, do_base, lse_base,
                delta_base, s_qm, s_om, offs_n, start, end, Sq, Sk, window,
                D: tl.constexpr, DA: tl.constexpr, DB: tl.constexpr,
                DV: tl.constexpr, DVB: tl.constexpr, BLOCK_M: tl.constexpr,
                MASK: tl.constexpr, CAUSAL: tl.constexpr,
                WINDOW: tl.constexpr):
    for m0 in range(start, end, BLOCK_M):
        offs_m = m0 + tl.arange(0, BLOCK_M)
        qa = _load(q_base, offs_m, s_qm, tl.arange(0, DA), Sq, D, MASK,
                   DA + DB != D)
        sT = tl.dot(ka, tl.trans(qa))
        if DB > 0:
            qb = _load(q_base + DA, offs_m, s_qm, tl.arange(0, DB), Sq, D,
                       MASK, False)
            sT = tl.dot(kb, tl.trans(qb), sT)
        if MASK:
            lse = tl.load(lse_base + offs_m, mask=offs_m < Sq, other=0.0)
            delta = tl.load(delta_base + offs_m, mask=offs_m < Sq, other=0.0)
        else:
            lse = tl.load(lse_base + offs_m)
            delta = tl.load(delta_base + offs_m)
        pT = tl.exp(sT - lse[None, :])
        if MASK:
            ok = _live(offs_m[None, :], offs_n[:, None], Sq, Sk, window,
                       CAUSAL, WINDOW)
            pT = tl.where(ok, pT, 0.0)
        do = _load(do_base, offs_m, s_om, tl.arange(0, DVB), Sq, DV, MASK,
                   DVB != DV)
        p_hi = pT.to(tl.bfloat16)
        dv = tl.dot(p_hi, do, dv)
        dv = tl.dot((pT - p_hi.to(tl.float32)).to(tl.bfloat16), do, dv)
        dpT = tl.dot(v, tl.trans(do))
        hi, mid, lo = _split3(pT * (dpT - delta[None, :]))
        dka = tl.dot(hi, qa, dka)
        dka = tl.dot(mid, qa, dka)
        dka = tl.dot(lo, qa, dka)
        if DB > 0:
            dkb = tl.dot(hi, qb, dkb)
            dkb = tl.dot(mid, qb, dkb)
            dkb = tl.dot(lo, qb, dkb)
    return dka, dkb, dv


@triton.jit
def attn_bwd_dkdv_kernel(Q, K, V, DO, LSE, DELTA, DK, DVO,
                         s_qb, s_qm, s_qh, s_kb, s_kn, s_kh, s_vb, s_vn,
                         s_vh, s_ob, s_om, s_oh, H, G, Sq, Sk, window,
                         D: tl.constexpr, DA: tl.constexpr,
                         DB: tl.constexpr, DV: tl.constexpr,
                         DVB: tl.constexpr, BLOCK_M: tl.constexpr,
                         BLOCK_N: tl.constexpr, CAUSAL: tl.constexpr,
                         WINDOW: tl.constexpr):
    pid_n = tl.program_id(0)
    bk = tl.program_id(1)
    KV = H // G
    b = (bk // KV).to(tl.int64)
    kvh = bk % KV
    start_n = pid_n * BLOCK_N
    offs_n = start_n + tl.arange(0, BLOCK_N)
    offs_dv = tl.arange(0, DVB)
    k_base = K + b * s_kb + kvh * s_kh
    ka = _load(k_base, offs_n, s_kn, tl.arange(0, DA), Sk, D, True,
               DA + DB != D)
    kb = ka
    dkb = tl.zeros([BLOCK_N, DA], tl.float32)
    if DB > 0:
        kb = _load(k_base + DA, offs_n, s_kn, tl.arange(0, DB), Sk, D, True,
                   False)
        dkb = tl.zeros([BLOCK_N, DB], tl.float32)
    v = _load(V + b * s_vb + kvh * s_vh, offs_n, s_vn, offs_dv, Sk, DV, True,
              DVB != DV)
    dka = tl.zeros([BLOCK_N, DA], tl.float32)
    dv = tl.zeros([BLOCK_N, DVB], tl.float32)
    lo, f_lo, f_hi, hi = _query_ranges(start_n, Sq, window, BLOCK_M,
                                       BLOCK_N, CAUSAL, WINDOW)
    for g in range(0, G):
        h = kvh * G + g
        q_base = Q + b * s_qb + h * s_qh
        do_base = DO + b * s_ob + h * s_oh
        row = (b * H + h) * Sq
        dka, dkb, dv = _dkdv_tiles(dka, dkb, dv, ka, kb, v, q_base, do_base,
                                   LSE + row, DELTA + row, s_qm, s_om,
                                   offs_n, lo, f_lo, Sq, Sk, window, D, DA,
                                   DB, DV, DVB, BLOCK_M, True, CAUSAL,
                                   WINDOW)
        dka, dkb, dv = _dkdv_tiles(dka, dkb, dv, ka, kb, v, q_base, do_base,
                                   LSE + row, DELTA + row, s_qm, s_om,
                                   offs_n, f_lo, f_hi, Sq, Sk, window, D, DA,
                                   DB, DV, DVB, BLOCK_M, False, CAUSAL,
                                   WINDOW)
        dka, dkb, dv = _dkdv_tiles(dka, dkb, dv, ka, kb, v, q_base, do_base,
                                   LSE + row, DELTA + row, s_qm, s_om,
                                   offs_n, f_hi, hi, Sq, Sk, window, D, DA,
                                   DB, DV, DVB, BLOCK_M, True, CAUSAL,
                                   WINDOW)
    # dk (B, Sk, KV, D), dv (B, Sk, KV, DV) contiguous
    dk_base = DK + (b * Sk * KV + kvh) * D
    _store(dk_base, dka.to(tl.bfloat16), offs_n, KV * D, tl.arange(0, DA),
           Sk, D, DA + DB != D)
    if DB > 0:
        _store(dk_base + DA, dkb.to(tl.bfloat16), offs_n, KV * D,
               tl.arange(0, DB), Sk, D, False)
    _store(DVO + (b * Sk * KV + kvh) * DV, dv.to(tl.bfloat16), offs_n,
           KV * DV, offs_dv, Sk, DV, DVB != DV)
