"""The plain reference agrees with the program at a small size on the
CPU (float32 compute): one LowDiff step (loss, top-k indices exactly,
values, params and moments) and a recovery of three differentials, on a
reduced gpt2-l and a reduced DeepSeekMoE."""
import pytest
import torch

from conftest import _tiny_config, _tiny_traffic

from chipbench import inputs, program
from chipbench.reference import decoder, optim

CPU = torch.device("cpu")
SEED = 2**31 + 99


def _setup(family, **traffic):
    torch.set_num_threads(1)
    m = _tiny_config(family)
    t = dict(_tiny_traffic("lowdiff_topk_b4s1024"), **traffic)
    model = program.build_model(m)
    w = inputs.weights(m, SEED, CPU)
    strat = program.lowdiff(model, program.ram_store(t), t, CPU)
    return m, t, w, strat, program.init_state(model, w, t, CPU)


def _ref_step(m, t, flat, mu, nu, ef, batch, count):
    prec = decoder.Precision(decoder.DTYPES[m["compute_dtype"]])
    loss, grads = decoder.gradients(flat, batch, m, prec)
    adam = optim.Adam(lr=t["lr"])
    picks = {}
    for k in flat:
        corrected = grads[k] + ef[k]
        picks[k] = optim.topk(corrected, t["rho"])
        g = optim.densify(*picks[k], corrected.shape)
        ef[k] = corrected - g
        flat[k], mu[k], nu[k] = adam.step(flat[k], g, mu[k], nu[k], count)
    return float(loss), picks


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_one_lowdiff_step(family):
    m, t, w, strat, state = _setup(family)
    got = []
    produce = strat.step_fn
    strat.step_fn = lambda s, b: got.append(produce(s, b)) or got[-1]
    batch = next(inputs.Batches(m["vocab"], t["batch"], t["seq"], SEED,
                                CPU))
    state, met = strat.train_step(state, batch)
    strat.close()
    flat = {k: v.clone() for k, v in w.items()}
    zeros = {k: torch.zeros(v.shape) for k, v in w.items()}
    mu, nu, ef = dict(zeros), dict(zeros), dict(zeros)
    loss, picks = _ref_step(m, t, flat, mu, nu, ef, batch, 1)
    assert float(met["loss"]) == pytest.approx(loss, rel=1e-6)
    payload = program.sparse_leaves(got[0][2])
    for k, (vals, idx) in picks.items():
        pv, pi, _ = payload[k]
        assert torch.equal(pi.long(), idx), k
        torch.testing.assert_close(pv.float(), vals, rtol=1e-5, atol=1e-7)
    params = program.flatten(state["params"])
    for k in flat:
        torch.testing.assert_close(params[k].float(), flat[k].float(),
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(program.flatten(state["opt"].mu)[k],
                                   mu[k], rtol=1e-5, atol=1e-8)
        torch.testing.assert_close(program.flatten(state["opt"].nu)[k],
                                   nu[k], rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_recovery_of_three_differentials(family):
    m, t, w, strat, state = _setup(family, full_interval=4, start_step=3,
                                   replay_device=True)
    batches = list(zip(range(4), inputs.Batches(
        m["vocab"], t["batch"], t["seq"], SEED, CPU)))
    for _, b in batches:
        state, _ = strat.train_step(state, b)
    strat.flush()
    del state
    rec, applied = strat.recover()
    strat.close()
    assert applied == 3 and int(rec["step"]) == 7
    flat = {k: v.clone() for k, v in w.items()}
    zeros = {k: torch.zeros(v.shape) for k, v in w.items()}
    mu, nu, ef = dict(zeros), dict(zeros), dict(zeros)
    for i, b in batches:
        _ref_step(m, t, flat, mu, nu, ef, b, i + 1)
    params = program.flatten(rec["params"])
    for k in flat:
        torch.testing.assert_close(params[k].float(), flat[k].float(),
                                   rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(program.flatten(rec["opt"].mu)[k],
                                   mu[k], rtol=1e-4, atol=1e-8)
