"""The port's roofline machinery (``repro_torch.analysis``) against the
JAX reference's (``tests/test_roofline.py`` on the port): the
segment-composed cost of fake runs against one fake run of the whole
sharded step, the segments against the step's parts, the collective
parser against the reference's on the same HLO text and on a recorded
fake-group pattern, ``model_flops`` and ``replay_roofline`` against the
reference's, the matrix-product count against an analytic one, and the
composed FLOPs against the reference's XLA count.

Every fake run happens inside ``fake_world(1)``: a ``fake``-backend
process group of one rank, made and destroyed by the call."""
import pytest
import torch

from repro.analysis import roofline as jroof
from repro.analysis.hlo_stats import collective_bytes as jax_collective_bytes
from repro.analysis.segments import compose as jax_compose
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.distributed import sharding as jshd
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models.registry import build_model as jax_model
from repro_torch import tree_leaves
from repro_torch.analysis import roofline as roof
from repro_torch.analysis.hlo_stats import collective_bytes, op_histogram
from repro_torch.analysis.segments import compose, fake_run, local_blocks
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.step_builder import make_sharded_train_step
from repro_torch.launch.dryrun import run_fake
from repro_torch.launch.mesh import (HBM_BW, ICI_BW, PEAK_FLOPS,
                                     PEAK_FLOPS_F32, fake_world,
                                     make_local_mesh)
from repro_torch.models.registry import build_model

torch.set_num_threads(1)

SHAPE = ShapeConfig("t", 128, 4, "train")


def _small_cfg(get=get_config):
    return get("qwen2-1.5b").reduced().replace(n_layers=2, loss_chunk=64)


@pytest.fixture(scope="module")
def small():
    """(model, composed train cost, whole-step fake run) on the (1, 1)
    mesh of a fake group of one rank."""
    model = build_model(_small_cfg())
    with fake_world(1), shd.use_mesh(make_local_mesh(1, 1)):
        comp = compose(model, SHAPE)
        step, ast, ab = make_sharded_train_step(model, SHAPE,
                                                mode="lowdiff_sharded")
        whole = run_fake(step, (local_blocks(ast), ab))
    return model, comp, whole


def test_composed_matches_whole_step(small):
    """The composition against one fake run of the whole sharded step.
    The step adds the final norm, the micro-batch glue and the loss
    scaling; the composition the reduction probes. Require ~15%, as the
    reference does (they agree to <1% on FLOPs here)."""
    _, comp, whole = small
    composed = comp["total"]["flops"]
    full = whole["cost"]["flops"]
    assert abs(composed - full) / full < 0.15, (composed, full)
    # the same op record: eager bytes and collectives agree too
    assert abs(comp["total"]["bytes"] - whole["cost"]["bytes_accessed"]) \
        / whole["cost"]["bytes_accessed"] < 0.15
    assert abs(comp["total"]["coll_bytes"]
               - whole["collectives"]["total"]) <= 64


def test_composed_segments_cover_step(small):
    model, comp, _ = small
    names = {s["segment"] for s in comp["segments"]}
    assert {"embed", "loss_head", "gather", "reduce", "optimizer",
            "compress"} <= names
    assert any(n.startswith("layer") for n in names)
    assert comp["total"]["flops"] > 0
    assert comp["total"]["bytes"] > 0
    # the gathers and the reduce carry the step's collectives: one
    # all-gather and one all-reduce of every parameter, f32 both ways
    segs = {s["segment"]: s for s in comp["segments"]}
    n_leaves = len(tree_leaves(model.abstract_params()))
    assert segs["gather"]["coll_count"] == n_leaves
    assert segs["reduce"]["coll_count"] == n_leaves
    assert segs["gather"]["coll_bytes"] == segs["reduce"]["coll_bytes"] \
        == 4 * model.n_params()


SYNTHETIC_HLO = """
  %ar = f32[128,256]{1,0} all-reduce(f32[128,256]{1,0} %x), replica_groups={}
  %ag = (bf16[64]{0}, bf16[64]{0}) all-gather(bf16[32]{0} %a, bf16[32]{0} %b), dimensions={0}
  %done = f32[4]{0} all-reduce-done(f32[4]{0} %s)
  %rs = bf16[16,8]{1,0} reduce-scatter(bf16[256,8]{1,0} %g), dimensions={0}
  %cp = s32[10]{0} collective-permute-start(s32[10]{0} %c), source_target_pairs={{0,1}}
  %a2a = f32[8,4]{1,0} all-to-all(f32[8,4]{1,0} %t), dimensions={0}
"""


def test_collective_parser_matches_reference_on_hlo_text():
    assert collective_bytes(SYNTHETIC_HLO) == \
        jax_collective_bytes(SYNTHETIC_HLO)
    stats = collective_bytes(SYNTHETIC_HLO)
    assert stats["all-reduce"] == 128 * 256 * 4
    assert stats["all-gather"] == 64 * 2 * 2
    assert stats["collective-permute"] == 10 * 4
    assert stats["count"] == 5            # the -done half is not counted
    assert dict(op_histogram(SYNTHETIC_HLO))["all-reduce-done"] == 1


def test_recorded_fake_group_collectives():
    """An all-reduce of f32[128, 256] in a fake group is 131,072 B; the
    record's HLO rendering reads the same in both packages' parsers."""
    import torch.distributed as dist
    with fake_world(4):
        with fake_run() as (_, rec):
            x = torch.empty(128, 256)
            dist.all_reduce(x)
            out = torch.empty(4 * 64, dtype=torch.bfloat16)
            dist.all_gather_into_tensor(out, torch.empty(
                64, dtype=torch.bfloat16))
            part = torch.empty(16)
            dist.reduce_scatter_tensor(part, torch.empty(64))
            a2a = torch.empty(32)
            dist.all_to_all_single(a2a, torch.empty(32))
            (x @ x.T).sum()
    stats = collective_bytes(rec)
    assert stats["all-reduce"] == 131_072
    assert stats["all-gather"] == 4 * 64 * 2
    assert stats["reduce-scatter"] == 16 * 4
    assert stats["all-to-all"] == 32 * 4
    assert stats["count"] == 4
    assert stats["total"] == 131_072 + 512 + 64 + 128
    assert collective_bytes(rec.text()) == stats
    assert jax_collective_bytes(rec.text()) == stats
    assert dict(op_histogram(rec))["c10d.allreduce_"] == 1
    assert rec.bytes_moved() == 2 * (128 * 256 * 4) + 128 * 128 * 4 + \
        128 * 128 * 4 + 4        # mm (reads x twice, writes), sum


def test_decode_and_prefill_compose():
    model = build_model(_small_cfg())
    with fake_world(1), shd.use_mesh(make_local_mesh(1, 1)):
        for kind, B, S in [("decode", 4, 256), ("prefill", 2, 256)]:
            comp = compose(model, ShapeConfig("x", S, B, kind))
            assert comp["total"]["flops"] > 0
            assert {"gather", "lm_head"} <= {
                s["segment"] for s in comp["segments"]}


def test_model_flops_ratio_sane(small):
    """Useful-FLOPs ratio in (0, 1.2] for the train shape."""
    model, comp, _ = small
    ratio = roof.model_flops(model.cfg, SHAPE) / comp["total"]["flops"]
    assert 0 < ratio <= 1.2


def test_model_flops_equals_reference():
    from repro.configs import _REGISTRY as jax_registry
    from repro_torch.configs import PORT_ONLY, _REGISTRY
    assert set(_REGISTRY) - set(PORT_ONLY) == set(jax_registry)
    for arch in PORT_ONLY:
        cfg = get_config(arch)
        assert build_model(cfg).n_params() == cfg.param_count()
        assert roof.model_flops(cfg, INPUT_SHAPES["train_4k"]) > 0
    assert set(INPUT_SHAPES) == set(JAX_SHAPES)
    for arch in sorted(set(_REGISTRY) - set(PORT_ONLY)):
        for sid in INPUT_SHAPES:
            got = roof.model_flops(get_config(arch), INPUT_SHAPES[sid])
            want = jroof.model_flops(jax_config(arch), JAX_SHAPES[sid])
            assert got == want, (arch, sid)


def test_fake_runs_leave_real_tensor_caches_alone():
    """A real CPU step fills ``adam_hyper_traced``'s constant cache; a
    fake run after it (the same process, as in a test worker) must not
    take that real tensor (FakeTensorMode refuses it) nor leave a fake
    one behind for the next real step."""
    from repro_torch.kernels import ops as kops
    args = (1e-3, 0.9, 0.999, 1e-8)
    real = kops.adam_hyper_traced(*args, torch.ones((), dtype=torch.int32))
    with fake_run():
        fake = kops.adam_hyper_traced(*args,
                                      torch.ones((), dtype=torch.int32))
        assert tuple(fake.shape) == (1, 8)
    again = kops.adam_hyper_traced(*args, torch.ones((), dtype=torch.int32))
    assert type(again) is torch.Tensor and torch.equal(real, again)


@pytest.mark.parametrize("n", [0, 1, 19])
def test_replay_roofline_equals_reference(n):
    args = (12_869_637_120, 69_124_176, n)
    got = roof.replay_roofline(*args, bandwidth=3.35e12)
    assert got == jroof.replay_roofline(*args, bandwidth=3.35e12)
    assert roof.replay_roofline(*args, device="cuda")["bandwidth"] == \
        HBM_BW


def test_replay_roofline_cpu_measures_host_bandwidth():
    r = roof.replay_roofline(100, 10, 2, device="cpu")
    assert r["bandwidth"] > 0 and r["traffic_bytes"] == 2 * 210


def test_matmul_flops_equal_analytic_count():
    """One prefill layer of the small config: every matrix product of
    the block (q/k/v/o projections, the two attention products over the
    full S x S tile, the three SwiGLU products), 2 FLOPs a
    multiply-add."""
    cfg = _small_cfg()
    model = build_model(cfg)
    B, S = 2, 64
    with fake_world(1), shd.use_mesh(make_local_mesh(1, 1)):
        comp = compose(model, ShapeConfig("p", S, B, "prefill"))
    seg = {s["segment"]: s for s in comp["segments"]}
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    T = B * S
    proj = 2 * T * d * (H * hd + 2 * KV * hd) + 2 * T * H * hd * d
    attn = 2 * (2 * B * S * S * H * hd)
    ffn = 3 * 2 * T * d * f
    assert seg["layer_w0"]["flops"] == proj + attn + ffn
    assert seg["lm_head"]["flops"] == 2 * B * d * cfg.vocab


def test_composed_flops_against_reference_xla_count(small):
    """The reference's XLA count of the same segments on one device.
    XLA also counts elementwise and reduction work (norms, RoPE, softmax,
    Adam, the top-k's compares); the port counts matrix products only,
    and both run the same products (remat included). So the port's count
    is at most the reference's and within 5% of it (1.2% here, on a
    model whose elementwise work is small beside its matmuls)."""
    _, comp, _ = small
    cfg = _small_cfg(jax_config)
    with jshd.use_mesh(jax_local_mesh(1, 1)):
        want = jax_compose(jax_model(cfg), JaxShape("t", 128, 4, "train"))
    got = comp["total"]["flops"]
    ref = want["total"]["flops"]
    assert got <= ref
    assert (ref - got) / ref < 0.05, (got, ref)


def test_roofline_terms_use_the_h100_constants(small):
    model, comp, _ = small
    rec = roof.roofline_terms(model.cfg, comp, 1, SHAPE)
    # the reduced config computes in f32: the f32 peak bounds it
    assert model.cfg.compute_dtype == "float32"
    assert rec["peak_flops"] == PEAK_FLOPS_F32 == 67e12
    assert rec["compute_s"] == round(comp["total"]["flops"] / 67e12, 6)
    t = comp["total"]
    # one device: its collectives cross no link, they are local copies
    assert rec["collective_s"] == 0.0
    assert rec["memory_s"] == round((t["bytes"] + t["coll_bytes"]) / HBM_BW,
                                    6)
    many = roof.roofline_terms(model.cfg, comp, 256, SHAPE)
    assert many["memory_s"] == round(t["bytes"] / HBM_BW, 6)
    assert many["collective_s"] == round(t["coll_bytes"] / ICI_BW, 6)
    assert many["model_flops_per_chip"] * 256 == rec["model_flops_per_chip"]
    assert (HBM_BW, ICI_BW) == (3.35e12, 50e9)
    bf16 = model.cfg.replace(compute_dtype="bfloat16")
    assert roof.roofline_terms(bf16, comp, 1, SHAPE)["peak_flops"] == \
        PEAK_FLOPS == 989e12
    assert rec["dominant"] in ("compute", "memory", "collective")
