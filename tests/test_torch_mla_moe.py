"""DeepSeek-V2-Lite on the port (multi-head latent attention, YaRN, a
leading dense layer, un-renormalised gates, a share of the experts)
against the benchmark's plain reference of the same equations
(``chipbench/reference/families/mla_moe.py``), on the CPU at a small
size in float32 from seeded random weights; the registry entry, its
counts, its decode refusal, and LowDiff's step and chain recovery over
the two layer stacks."""
import dataclasses
import json
import math
import os
import sys

import pytest
import torch

from repro_torch import tree_leaves
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import PORT_ONLY, get_config
from repro_torch.configs.base import YarnScaling
from repro_torch.core import recovery as rec
from repro_torch.core import steps
from repro_torch.core.lowdiff import LowDiff
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels import build, ref
from repro_torch.models import mla, moe, ops
from repro_torch.models.param import is_spec, is_stacked
from repro_torch.models.registry import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from chipbench import inputs, program  # noqa: E402
from chipbench.reference import decoder  # noqa: E402

#: float32 on both sides, summed in other orders (the softmax normalised
#: before or after the value product, experts as one batched matmul over
#: capacity buffers or one gather each, other index_add orders): each
#: leaf's gradient reads ~1.5e-6 of its norm apart over three layers; the
#: reference in bfloat16 reads ~1e-2 apart (``test_tolerance_rejects_bf16``)
GRAD_TOL = 1e-5
#: the loss: one scalar through the same sums, ~1e-7 apart
LOSS_TOL = 1e-6

#: the small sizes (the benchmark configuration's keys); 1 dense layer
#: and 2 MoE layers, 8 experts
SMALL = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
             vocab=256, param_dtype="float32", compute_dtype="float32",
             n_experts=8, held_experts=0, top_k=2, n_shared=1, expert_ff=32,
             dense_ff=128, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, grad_accum=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (six workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _conf(**kw) -> dict:
    """The benchmark's DeepSeek-V2-Lite file at the small sizes, with the
    program's overrides for the same sizes."""
    with open(os.path.join(ROOT, "chipbench", "configs",
                           "deepseek-v2-lite-l5.json"),
              encoding="utf-8") as f:
        m = json.load(f)
    m.update(SMALL, **kw)
    fam = decoder.family(m)
    port = {k: m[k] for k in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                              "vocab", "param_dtype", "compute_dtype",
                              "grad_accum", "norm_eps")}
    for k, path in fam.PROGRAM_KEYS.items():
        node = port
        *outer, last = path.split(".")
        for name in outer:
            node = node.setdefault(name, {})
        node[last] = m[k]
    m["port_overrides"] = port
    return m


def _both(m, seed=5, batch=2, seq=32):
    """(port (loss, {leaf: grad}), reference (loss, {leaf: grad})) of one
    step from the seed's weights and batch."""
    model = program.build_model(m)
    w = inputs.weights(m, seed, "cpu")
    program.check_layout(model, w)
    b = next(inputs.Batches(m["vocab"], batch, seq, seed, "cpu"))
    ref = decoder.gradients(w, b, m, decoder.Precision(torch.float32))
    loss, _, g = steps._grads(model, decoder.nest(w), b, m["grad_accum"])
    return (loss, program.flatten(g)), ref, (w, b)


def _gap(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("kw", [{}, {"held_experts": 4},
                                {"norm_topk": True, "grad_accum": 2}],
                         ids=["all-experts", "held-4-of-8", "norm-accum2"])
def test_loss_and_every_gradient_leaf_match_the_reference(kw):
    (loss, g), (rloss, rg), _ = _both(_conf(**kw), batch=4 if kw else 2)
    assert abs(float(loss) - float(rloss)) <= LOSS_TOL * abs(float(rloss))
    assert sorted(g) == sorted(rg)
    assert any(k.startswith("dense_layers.") for k in g)
    gaps = {k: _gap(g[k], rg[k]) for k in rg}
    assert max(gaps.values()) < GRAD_TOL, gaps


def test_tolerance_rejects_bf16():
    """The reference with bfloat16 matmul inputs, the nearest precision
    below the configuration's, falls outside the tolerances."""
    m = _conf()
    (loss, g), _, (w, b) = _both(m)
    rloss, rg = decoder.gradients(w, b, m, decoder.Precision(torch.bfloat16))
    gaps = [_gap(g[k], rg[k]) for k in rg]
    assert max(gaps) > 10 * GRAD_TOL
    assert abs(float(loss) - float(rloss)) > LOSS_TOL * abs(float(rloss))


def test_yarn_and_softmax_scale_at_the_published_numbers():
    """DeepSeek-V2-Lite's rotation: 64 rotated dims, theta 1e4, factor 40
    over 4096 positions, beta 32/1, mscale = mscale_all_dim = 0.707. The
    correction range is pairs 10..23 (floor 10.47, ceil 22.50); pair i
    turns at theta^(-2i/64), divided by 40 past it, a linear ramp
    between; cos/sin keep magnitude 1; the scale is 192^-1/2 m^2 with
    m = 0.1 * 0.707 * ln 40 + 1."""
    s = get_config("deepseek-v2-lite").rope_scaling
    assert s == YarnScaling()
    corr = [64 * math.log(4096 / (r * 2 * math.pi)) / (2 * math.log(1e4))
            for r in (32, 1)]
    assert (math.floor(corr[0]), math.ceil(corr[1])) == (10, 23)
    want = []
    for i in range(32):
        base = 1e4 ** (-2 * i / 64)
        ramp = min(max((i - 10) / 13, 0.0), 1.0)
        want.append(base / 40 * ramp + base * (1 - ramp))
    got = ops.yarn_freqs(64, 1e4, s)
    assert got.dtype == torch.float32 and got.shape == (32,)
    torch.testing.assert_close(got, torch.tensor(want), rtol=2e-7, atol=0)
    assert float(got[10]) == pytest.approx(1e4 ** (-20 / 64), rel=1e-6)
    assert float(got[23]) == pytest.approx(1e4 ** (-46 / 64) / 40, rel=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m == pytest.approx(1.2608, abs=1e-4)
    assert mla.softmax_scale(get_config("deepseek-v2-lite")) == \
        pytest.approx(192 ** -0.5 * m * m, rel=1e-15)
    # cos and sin keep magnitude 1: a rotation at position 0 is the identity
    x = torch.randn(1, 3, 2, 64)
    y = ops.apply_rope(x, torch.arange(3), 1e4, s)
    torch.testing.assert_close(y[:, 0], x[:, 0])
    torch.testing.assert_close(y.norm(dim=-1), x.norm(dim=-1))
    # the reference's frequencies from the same equations
    fam = decoder.family(_conf())
    ref = fam.yarn_inv_freq(64, dict(_conf(), qk_rope_head_dim=64))
    torch.testing.assert_close(got, ref, rtol=2e-7, atol=0)


def test_gates_without_renormalisation():
    """``norm_topk=False``: the gates are the router's top-k softmax
    probabilities as they are; ``True`` divides them by their sum."""
    cfg = get_config("deepseek-v2-lite").reduced()
    assert cfg.moe.norm_topk is False
    g = torch.Generator().manual_seed(3)
    xf = torch.randn(40, cfg.d_model, generator=g)
    # logits of std 1/2: top-2 of 4 hold about two thirds of the mass
    router = torch.randn(cfg.d_model, cfg.moe.n_experts, generator=g) \
        / (2 * cfg.d_model ** 0.5)
    gate, eid, _ = moe._gates(router, xf, cfg)
    probs = torch.softmax(xf @ router, dim=-1)
    assert torch.equal(gate, torch.gather(probs, 1, eid))
    assert float(gate.sum(-1).max()) < 0.99
    on = cfg.replace(moe=dataclasses.replace(cfg.moe, norm_topk=True))
    gate1, eid1, _ = moe._gates(router, xf, on)
    assert torch.equal(eid1, eid)
    torch.testing.assert_close(gate1, gate / gate.sum(-1, keepdim=True))


def _halves(p, E):
    lo = {k: (v[:E // 2] if k.startswith("we_") else v) for k, v in p.items()}
    hi = {k: v[E // 2:] for k, v in p.items() if k.startswith("we_")}
    hi["router"] = p["router"]
    return lo, hi


def test_shares_of_the_experts_add_up_to_the_whole_layer():
    """Experts [0, E/2) with the shared expert, plus experts [E/2, E)
    without it, give the uncut layer's output, in the port and in the
    reference (each share routes over all E experts with their
    capacity); float32, so only the order of the last sums differs."""
    m = _conf()
    E = m["n_experts"]
    g = torch.Generator().manual_seed(11)
    x = torch.randn(2, 24, m["d_model"], generator=g)
    flat = inputs.weights(m, 9, "cpu")
    p = {k.split(".")[-1]: v[0] for k, v in flat.items()
         if k.startswith("layers.moe.")}
    lo, hi = _halves(p, E)
    # the port
    cfg = program.arch_config(m)
    whole, aux = moe._moe_apply_dense(p, x, cfg)
    half = cfg.replace(moe=dataclasses.replace(cfg.moe, held_experts=E // 2))
    y_lo, aux_lo = moe._moe_apply_dense(lo, x, half)
    # the other card's share: the same router, plan and experts, from E/2
    T, K = x.shape[0] * x.shape[1], m["top_k"]
    C = moe.capacity(T, cfg)
    xf = x.reshape(T, -1)
    gate, eid, aux_hi = moe._gates(hi["router"], xf, cfg)
    dest, valid, src = moe.moe_kernels.plan(eid, E // 2, E // 2, C)
    y_hi = moe._experts(moe._dispatch(xf, src, dest, E // 2, K), gate, dest,
                        valid, src, hi["we_g"], hi["we_u"], hi["we_d"], K)
    y_hi = y_hi.reshape(x.shape)
    torch.testing.assert_close(y_lo + y_hi, whole, rtol=1e-6, atol=1e-6)
    assert torch.equal(aux_lo, aux) and torch.equal(aux_hi, aux)
    assert not torch.allclose(y_hi, torch.zeros_like(y_hi))
    # the reference
    fam = decoder.family(m)
    prec = decoder.Precision(torch.float32)
    r_whole, r_aux = decoder.routed_experts(p, x, dict(m, norm_topk=False),
                                            prec)
    r_lo, _ = fam.held_experts(lo, x, m, prec)
    r_hi, _ = fam.held_experts(hi, x, m, prec, first=E // 2)
    torch.testing.assert_close(r_lo + r_hi, r_whole, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(y_lo, r_lo, rtol=1e-5, atol=1e-6)


def _plan_over_all_experts(eid, E: int, C: int):
    """The dispatch plan the layer took before it could hold a share:
    the exclusive cumsum of the (T·K, E) one-hot of every assignment."""
    T, K = eid.shape
    oh_flat = torch.nn.functional.one_hot(eid, E).float().reshape(T * K, E)
    pos = torch.cumsum(oh_flat, dim=0) - oh_flat
    pos_in_e = (pos * oh_flat).sum(dim=-1).to(torch.int64)
    eid_flat = eid.reshape(T * K)
    valid = pos_in_e < C
    return torch.where(valid, eid_flat * C + pos_in_e,
                       torch.full_like(eid_flat, E * C)), valid


@pytest.mark.parametrize("cf", [1.0, 2.5])
def test_defaults_keep_the_moe_layer_bit_for_bit(cf):
    """With every expert held and renormalised gates (the defaults), the
    plan over the experts ``[0, E)`` is the cumsum plan over all experts
    the layer took before, bit for bit, with drops (capacity factor 1)
    and without."""
    base = get_config("deepseek-moe-16b").reduced()
    cfg = base.replace(moe=dataclasses.replace(base.moe, capacity_factor=cf))
    assert cfg.moe.norm_topk is True and cfg.moe.held_experts == 0
    assert cfg.moe.held() == cfg.moe.n_experts
    p = {k: v[0] for k, v in build_model(cfg).init(4, device="cpu")
         ["layers"]["moe"].items()}
    T, E = 64, cfg.moe.n_experts
    xf = torch.randn(T, cfg.d_model, generator=torch.Generator()
                     .manual_seed(4))
    C = moe.capacity(T, cfg)
    gate, eid, dest, valid, _ = moe.route(p, xf, cfg, C)
    want_dest, want_valid = _plan_over_all_experts(eid, E, C)
    assert torch.equal(dest, want_dest) and torch.equal(valid, want_valid)
    assert bool(valid.all()) == (cf > 1.0)


def _parent_experts(xe, gate, dest, valid, wg, wu, wd, K: int):
    """The layer's experts and combine before the slot map (the combine
    ``ref.moe_drop_row_combine_ref``)."""
    E, C, d = xe.shape
    dt = xe.dtype
    g = torch.bmm(xe, wg.to(dt))
    u = torch.bmm(xe, wu.to(dt))
    h = torch.nn.functional.silu(g.float()).to(dt) * u
    ye = torch.bmm(h, wd.to(dt))
    return ref.moe_drop_row_combine_ref(ye.reshape(E * C, d), gate, dest,
                                        valid, K)


def _parent_moe_dense(p, x, cfg):
    """``moe._moe_apply_dense`` as it was before the slot map."""
    B, S, d = x.shape
    m = cfg.moe
    n, K = m.held(), m.top_k
    T = B * S
    C = moe.capacity(T, cfg)
    xf = x.reshape(T, d)
    gate, eid, aux = moe._gates(p["router"], xf, cfg)
    dest, valid = ref.moe_cumsum_plan_ref(eid, 0, n, C)
    y = _parent_experts(ref.moe_scatter_dispatch_ref(xf, dest, n, C, K),
                        gate, dest, valid, p["we_g"], p["we_u"], p["we_d"], K)
    if m.n_shared:
        y = y + moe._shared_expert(p, xf, x.dtype)
    return y.reshape(B, S, d), aux


def _moe_case(cf: float, held: int, dtype, T: int = 96, seed: int = 4):
    """Reduced DeepSeekMoE with 8 experts, top-3, at capacity factor
    ``cf`` holding ``held`` experts (0: all) in ``dtype``: (cfg, layer
    params, x (2, T/2, d)), the router scaled so that its softmax picks
    experts unevenly."""
    base = get_config("deepseek-moe-16b").reduced()
    cfg = base.replace(compute_dtype=str(dtype).split(".")[-1],
                       moe=dataclasses.replace(base.moe, n_experts=8,
                                               top_k=3, capacity_factor=cf,
                                               held_experts=held))
    p = {k: v[0] for k, v in build_model(cfg).init(seed, device="cpu")
         ["layers"]["moe"].items()}
    g = torch.Generator().manual_seed(seed)
    p["router"] = p["router"] * 20.0
    x = torch.randn(2, T // 2, cfg.d_model, generator=g).to(dtype)
    return cfg, p, x


@pytest.mark.parametrize("share", ["all", "low-half", "high-half"])
@pytest.mark.parametrize("cf", [1.0, 2.5])
def test_slot_plan_is_the_cumsum_plan_and_its_inverse(cf, share):
    """The slot map's dest and valid are the cumsum plan's bit for bit,
    with drops (capacity factor 1) and without, for the whole expert
    set and for each half; src is dest's exact inverse: src[dest[a]] ==
    a for every kept a, and every other slot holds -1."""
    cfg, p, x = _moe_case(cf, 0, torch.float32, T=256)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    first, n = {"all": (0, E), "low-half": (0, E // 2),
                "high-half": (E // 2, E // 2)}[share]
    T = x.shape[0] * x.shape[1]
    C = moe.capacity(T, cfg)
    _, eid, _ = moe._gates(p["router"], x.reshape(T, -1), cfg)
    dest, valid, src = moe.moe_kernels.plan(eid, first, n, C)
    want_dest, want_valid = ref.moe_cumsum_plan_ref(eid, first, n, C)
    assert torch.equal(dest, want_dest) and torch.equal(valid, want_valid)
    kept = torch.nonzero(valid)[:, 0]
    assert torch.equal(src[dest[kept]], kept)
    empty = torch.ones(n * C, dtype=torch.bool)
    empty[dest[kept]] = False
    assert bool((src[empty] == -1).all())
    assert src.shape == (n * C,) and src.dtype == torch.int64
    # drops happen at capacity factor 1 and not at 2.5
    mine = ((eid - first >= 0) & (eid - first < n)).reshape(-1)
    assert bool((valid == mine).all()) == (cf > 1.0)


@pytest.mark.parametrize("held", [0, 4], ids=["all-experts", "held-4-of-8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_layer_is_the_parent_formulation(dtype, held):
    """The MoE layer through the slot map against its formulation before
    (cumsum plan, scatter-adds, gathers from a drop row): the output and
    the gradients of the expert weights bit for bit; the gradients of
    the input and the router (sums over k and over d in another order)
    within GRAD_TOL in f32, and within the roundings of a K-term bf16 sum
    in bf16; drops included (capacity factor 1)."""
    cfg, p, x = _moe_case(1.0, held, dtype)
    assert cfg.moe.n_experts == 8 and (held == 0 or cfg.moe.held() == held)

    def run(fn):
        pt = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xt = x.clone().requires_grad_(True)
        y, aux = fn(pt, xt, cfg)
        dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)
                         ).to(dtype)
        names = sorted(pt)
        grads = torch.autograd.grad((y.float() * dy.float()).sum() + aux,
                                    [pt[k] for k in names] + [xt])
        return y, aux, dict(zip(names + ["x"], grads))

    y, aux, g = run(moe._moe_apply_dense)
    py, paux, pg = run(_parent_moe_dense)
    assert torch.equal(y, py) and torch.equal(aux, paux)
    for k in ("we_g", "we_u", "we_d"):
        assert torch.equal(g[k], pg[k]), k
    # bf16: K - 1 rounded adds of the K terms of the input's gradient on
    # each side, in another order, each within half a spacing (2^-9)
    K = cfg.moe.top_k
    tol = GRAD_TOL if dtype == torch.float32 else 2 * (K - 1) * 2.0 ** -9
    gaps = {k: _gap(g[k].float(), pg[k].float()) for k in g}
    assert max(gaps.values()) < tol, gaps


def test_dense_layers_get_per_layer_autograd_leaves():
    """``dense_layers`` is a stack (every spec under it ``is_stacked``):
    each of its leaves is handed to the model as per-layer slices, each
    its own autograd leaf, and the step's gradient tree regroups them
    into the stacked shape."""
    cfg = get_config("deepseek-v2-lite").reduced().replace(n_layers=3)
    model = build_model(cfg)
    specs = tree_leaves(model.specs, is_leaf=is_spec)
    assert all(is_stacked(s) for s in
               tree_leaves(model.specs["dense_layers"], is_leaf=is_spec))
    params = model.init(0, device="cpu")
    assert params["dense_layers"]["attn"]["wkv_a"].shape[0] == 1
    assert params["layers"]["attn"]["wkv_a"].shape[0] == 2
    live, leaves, regroup = steps._differentiable(params, model.specs)
    wq = live["dense_layers"]["attn"]["wq"]
    assert isinstance(wq, list) and len(wq) == 1 and wq[0].is_leaf
    assert isinstance(live["layers"]["moe"]["we_g"], list)
    n = sum(p.shape[0] if is_stacked(s) else 1
            for p, s in zip(tree_leaves(params), specs))
    assert len(leaves) == n
    _, _, g = steps._grads(model, params,
                           make_batch(cfg, 16, 2, step=0), 1)
    for a, b in zip(tree_leaves(g), tree_leaves(params)):
        assert a.shape == b.shape


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_lowdiff_step_and_chain_recovery_bitwise(tmp_path):
    """LowDiff over the two stacks (half the experts held): 7 steps with a
    full every 4, then the
    chain (a full and 3 differentials) replayed serially and on the
    device bit for bit alike, and recovery equal to the trained state."""
    full = get_config("deepseek-v2-lite")
    cfg = full.replace(moe=dataclasses.replace(full.moe, held_experts=32)
                       ).reduced()
    assert cfg.moe.held_experts == 2 and cfg.first_dense_layers == 1
    model = build_model(cfg)
    strat = LowDiff(model, CheckpointStore(str(tmp_path)), full_interval=4,
                    batch_size=2, device="cpu", replay_device=True,
                    parallel_recovery=False)
    state = steps.init_state(model, 1, device="cpu")
    for t in range(7):
        state, _ = strat.train_step(state, make_batch(cfg, 32, 2, step=t))
    strat.flush()
    trained = tree_leaves((state["params"], state["opt"]))
    recovered, applied = strat.recover()
    strat.close()
    assert applied == 3 and int(recovered["step"]) == 7
    for a, b in zip(tree_leaves((recovered["params"], recovered["opt"])),
                    trained):
        assert torch.equal(_bits(a), _bits(b))
    full, diffs = rec.load_latest_chain(CheckpointStore(str(tmp_path)))
    diffs = rec.contiguous_prefix(int(full["step"]), diffs)
    sp, sopt = rec.replay_serial(full["params"], full["opt"], diffs,
                                 device="cpu")
    dp, dopt, n = rec.replay_device(full["params"], full["opt"], diffs,
                                    device="cpu")
    assert n == len(diffs) == 3
    for a, b in zip(tree_leaves((dp, dopt)), tree_leaves((sp, sopt))):
        assert torch.equal(_bits(a), _bits(b))


def test_decode_refuses_mla():
    model = build_model(get_config("deepseek-v2-lite").reduced())
    with pytest.raises(NotImplementedError, match="MLA"):
        model.init_cache(1, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="MLA"):
        model.decode_step({}, None, {"tokens": torch.zeros(1, 1), "pos": 0},
                          16)


#: (param_count, active_param_count) of every other registry entry, full
#: and reduced, as before the port-only options came
COUNTS = {
    "qwen3-moe-235b-a22b": (235093610496, 22190739456, 1576192, 1182976),
    "seamless-m4t-medium": (978818048, 978818048, 5016832, 5016832),
    "pixtral-12b": (12777313280, 12777313280, 2393344, 2393344),
    "qwen2-1.5b": (1543656960, 1543656960, 2098432, 2098432),
    "stablelm-1.6b": (1644267520, 1644267520, 2360576, 2360576),
    "xlstm-350m": (254067712, 254067712, 1049856, 1049856),
    "granite-3-8b": (8372187136, 8372187136, 2360576, 2360576),
    "llama3-405b": (405853388800, 405853388800, 2360576, 2360576),
    "hymba-1.5b": (1639326400, 1639326400, 3179776, 3179776),
    "deepseek-moe-16b": (16879568896, 2830747648, 1772800, 1379584),
    "gpt2-l": (1072469760, 1072469760, 2360576, 2360576),
}


@pytest.mark.parametrize("arch", sorted(COUNTS))
def test_param_counts_of_the_other_configs_unchanged(arch):
    c = get_config(arch)
    r = c.reduced()
    assert (c.param_count(), c.active_param_count(), r.param_count(),
            r.active_param_count()) == COUNTS[arch]


@pytest.mark.parametrize("kw", [{}, {"n_layers": 5, "held_experts": 32}],
                         ids=["published", "one-card"])
def test_param_count_is_the_spec_trees(kw):
    """MLA, the leading dense layer and the held experts counted; the
    published model is 15.7B parameters, 2.66B active (2.45B without the
    input embedding); the benchmark's one-card cut 1,732,534,784."""
    c = get_config("deepseek-v2-lite")
    if kw:
        c = c.replace(n_layers=kw["n_layers"], moe=dataclasses.replace(
            c.moe, held_experts=kw["held_experts"]))
    model = build_model(c)
    assert c.param_count() == model.n_params()
    for r in (c, c.reduced()):
        assert r.param_count() == build_model(r).n_params()
    d, fe = c.d_model, c.moe.expert_ff
    experts = (c.n_layers - 1) * 3 * d * fe * c.moe.held()
    picked = experts * c.moe.top_k // c.moe.n_experts
    assert c.active_param_count() == c.param_count() - experts + picked
    if not kw:
        assert c.param_count() == 15_706_484_224
        assert c.active_param_count() - c.vocab * d == 2_451_435_008
    else:
        assert c.param_count() == 1_732_534_784
    # the benchmark's reference counts the same tree
    m = _conf(**{k: getattr(c, k) for k in ("n_layers", "d_model", "vocab")},
              n_heads=16, n_kv_heads=16, head_dim=128, n_experts=64,
              held_experts=c.moe.held_experts, top_k=6, n_shared=2,
              expert_ff=1408, dense_ff=10944, kv_lora_rank=512,
              qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)
    shapes = decoder.param_shapes(m)
    assert sum(math.prod(s) for s, _ in shapes.values()) == c.param_count()
    assert decoder.family(m).active_params(m) == \
        c.active_param_count() - c.vocab * d


def test_port_only_entries_build_and_stay_out_of_the_assigned_list():
    from repro_torch.configs import ASSIGNED_ARCHS, _REGISTRY
    assert PORT_ONLY == ("deepseek-v2-lite",)
    for a in PORT_ONLY:
        assert a in _REGISTRY and a not in ASSIGNED_ARCHS
        cfg = get_config(a)
        assert build_model(cfg).n_params() == cfg.param_count()
        assert build_model(cfg.reduced()).n_params() > 0


def test_backward_opens_a_span_per_dispatch_and_combine():
    """With tracing on, each MoE layer call's backward opens two
    ``moe.route.bwd`` spans (the dispatch's and the combine's), one
    ``moe.route`` span per forward call, none with tracing off."""
    from repro_torch.obs.trace import TRACER
    cfg, p, x = _moe_case(1.25, 4, torch.float32)
    pt = {k: v.requires_grad_(True) for k, v in p.items()}
    was = TRACER.enabled
    TRACER.clear()
    TRACER.enable()
    try:
        y, aux = moe._moe_apply_dense(pt, x.requires_grad_(True), cfg)
        torch.autograd.grad(y.sum() + aux, [pt["router"], x])
        names = [e[0] for e in TRACER.events()]
    finally:
        if not was:
            TRACER.disable()
        TRACER.clear()
    assert names.count("moe.route") == 1
    assert names.count("moe.route.bwd") == 2


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


#: the benchmark's MoE cells, one micro-batch: DeepSeekMoE's 64 experts,
#: DeepSeek-V2-Lite's 32 held of 64 (T 4096, K 6, d 2048, C 480)
CARD_CELLS = {"dsmoe": ("deepseek-moe-16b", 0),
              "dsv2lite": ("deepseek-v2-lite", 32)}


def _card_layer(cell: str, dev, seed: int = 1):
    """(cfg, layer params, x (2, 2048, d) bf16) at a cell's widths, the
    params drawn at the scale of the benchmark's init."""
    arch, held = CARD_CELLS[cell]
    full = get_config(arch)
    cfg = full.replace(moe=dataclasses.replace(full.moe, held_experts=held))
    g = torch.Generator(device=dev).manual_seed(seed)
    p = {}
    for k, spec in moe.moe_specs(cfg, 1).items():
        shape = tuple(spec.shape[1:])
        dt = torch.float32 if k == "router" else torch.bfloat16
        p[k] = (torch.randn(shape, generator=g, device=dev)
                / shape[-2] ** 0.5).to(dt)
    x = torch.randn(2, 2048, cfg.d_model, generator=g, device=dev
                    ).to(torch.bfloat16)
    return cfg, p, x


def _card_plan(cell: str, dev):
    cfg, p, x = _card_layer(cell, dev)
    T = x.shape[0] * x.shape[1]
    C = moe.capacity(T, cfg)
    assert (T, cfg.moe.top_k, cfg.d_model, C) == (4096, 6, 2048, 480)
    gate, eid, _ = moe._gates(p["router"], x.reshape(T, -1), cfg)
    return cfg, p, x, gate, eid, C


def _bf16_spacing(x: torch.Tensor) -> torch.Tensor:
    """The distance from each bf16 value to the next one away from zero
    (the smallest normal's at zero)."""
    m, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(m), e - 8)


@pytest.mark.card
@pytest.mark.parametrize("cell", list(CARD_CELLS))
def test_card_plan_kernel_is_the_cumsum_plan(cell):
    """``moe_plan`` on the card: dest and valid equal the plain version
    and the cumsum plan bit for bit, src the plain version's; one
    launch."""
    dev = _card()
    cfg, _, _, _, eid, C = _card_plan(cell, dev)
    n = cfg.moe.held()
    n0 = build.LAUNCHES["moe_plan"]
    dest, valid, src = moe.moe_kernels.plan(eid, 0, n, C)
    torch.cuda.synchronize()
    assert build.LAUNCHES["moe_plan"] == n0 + 1
    want = ref.moe_plan_ref(eid, 0, n, C)
    for got, w in zip((dest, valid, src), want):
        assert torch.equal(got, w)
    cs_dest, cs_valid = ref.moe_cumsum_plan_ref(eid, 0, n, C)
    assert torch.equal(dest, cs_dest) and torch.equal(valid, cs_valid)


@pytest.mark.card
@pytest.mark.parametrize("cell", list(CARD_CELLS))
def test_card_gather_kernels_are_their_plain_versions(cell):
    """Both gathers in each of their uses on the card, at a cell's
    shapes: dispatch (slot rows), combine (gated sums), combine's
    backward (gated slot rows and the gates' dot products) and
    dispatch's backward (sums) bit for bit against the plain versions,
    the dot products within the f32 rounding of a sum in another
    order."""
    dev = _card()
    cfg, p, x, gate, eid, C = _card_plan(cell, dev)
    K, n = cfg.moe.top_k, cfg.moe.held()
    dest, valid, src = moe.moe_kernels.plan(eid, 0, n, C)
    xf = x.reshape(-1, cfg.d_model)
    T = xf.shape[0]
    g = torch.Generator(device=dev).manual_seed(5)
    ye = torch.randn(n * C, cfg.d_model, generator=g, device=dev
                     ).to(torch.bfloat16)
    dy = torch.randn(T, cfg.d_model, generator=g, device=dev
                     ).to(torch.bfloat16)
    w = (gate * valid.reshape(T, K)).to(torch.bfloat16).reshape(-1)
    kg = moe.moe_kernels
    n0 = dict(build.LAUNCHES)
    cases = [(kg.slot_gather(xf, src, K), ref.slot_gather_ref(xf, src, K)),
             (kg.assign_gather(ye, dest, K, w),
              ref.assign_gather_ref(ye, dest, K, w)),
             (kg.assign_gather(ye, dest, K), ref.assign_gather_ref(ye, dest,
                                                                   K))]
    dye, dots = kg.slot_gather(dy, src, K, w, ye)
    want_dye, want_dots = ref.slot_gather_ref(dy, src, K, w, ye)
    torch.cuda.synchronize()
    assert build.LAUNCHES["moe_slot_gather"] == n0["moe_slot_gather"] + 2
    assert build.LAUNCHES["moe_assign_gather"] == n0["moe_assign_gather"] + 2
    for got, want in cases + [(dye, want_dye)]:
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # each dot an f32 sum of d rounded products in another order: within
    # d f32 roundings of the sum of their magnitudes
    mag = ref.slot_gather_ref(dy.abs(), src, K, None, ye.abs())[1]
    assert bool(((dots - want_dots).abs()
                 <= cfg.d_model * 2.0 ** -24 * mag).all())


@pytest.mark.card
@pytest.mark.parametrize("cell", list(CARD_CELLS))
def test_card_layer_is_the_parent_formulation(cell):
    """The whole MoE layer on the card at a cell's widths, slot map
    against the formulation before it: the output and the expert
    weights' gradients bit for bit, the gates' gradient within one bf16
    spacing of the parent's (its f32 sums over d in another order), the
    input's and the router's within the roundings of a K-term bf16 sum
    in another order."""
    dev = _card()
    cfg, p, x = _card_layer(cell, dev)
    K = cfg.moe.top_k
    T = x.shape[0] * x.shape[1]
    dy = torch.randn(x.shape, generator=torch.Generator(device=dev)
                     .manual_seed(7), device=dev).to(torch.bfloat16)

    def run(fn):
        pt = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xt = x.clone().requires_grad_(True)
        gate_grads = []
        real = moe._gates

        def gates(router, xf, c):
            gate, eid, aux = real(router, xf, c)
            gate.register_hook(gate_grads.append)
            return gate, eid, aux
        moe._gates = gates
        try:
            y, aux = fn(pt, xt, cfg)
        finally:
            moe._gates = real
        names = sorted(pt)
        grads = torch.autograd.grad((y.float() * dy.float()).sum() + aux,
                                    [pt[k] for k in names] + [xt])
        return y, dict(zip(names + ["x"], grads)), gate_grads[0]

    n0 = dict(build.LAUNCHES)
    y, g, dgate = run(moe._moe_apply_dense)
    torch.cuda.synchronize()
    assert {k: build.LAUNCHES[k] - n0[k] for k in
            ("moe_plan", "moe_slot_gather", "moe_assign_gather")} == {
        "moe_plan": 1, "moe_slot_gather": 2, "moe_assign_gather": 2}
    py, pg, pdgate = run(_parent_moe_dense)
    assert torch.equal(y, py)
    for k in ("we_g", "we_u", "we_d"):
        assert torch.equal(g[k], pg[k]), k
    # dgate is f32 of a bf16 value times valid: one bf16 spacing apart
    assert dgate.shape == (T, K)
    assert bool(((dgate - pdgate).abs() <= _bf16_spacing(pdgate)).all())
    tol = 2 * (K - 1) * 2.0 ** -9       # K - 1 bf16 adds on each side
    assert _gap(g["x"].float(), pg["x"].float()) < tol
    assert _gap(g["router"], pg["router"]) < tol


@pytest.mark.card
def test_card_training_step_launches_the_kernels_on_every_layer_call():
    """One training step of reduced DeepSeekMoE (2 MoE layers, 2
    micro-batches, remat) on the card: per layer call one plan and one
    of each gather in the forward and again in its recompute, and one of
    each gather in the backward."""
    dev = _card()
    cfg = get_config("deepseek-moe-16b").reduced().replace(
        compute_dtype="bfloat16", grad_accum=2)
    assert cfg.remat and cfg.n_layers == 2
    model = build_model(cfg)
    params = model.init(0, device=dev)
    batch = {k: v.to(dev) for k, v in make_batch(cfg, 64, 4, step=0).items()}
    build.reset_launches()
    steps._grads(model, params, batch, cfg.grad_accum)
    torch.cuda.synchronize()
    calls = cfg.n_layers * cfg.grad_accum
    assert {k: build.LAUNCHES[k] for k in
            ("moe_plan", "moe_slot_gather", "moe_assign_gather")} == {
        "moe_plan": 2 * calls, "moe_slot_gather": 3 * calls,
        "moe_assign_gather": 3 * calls}
