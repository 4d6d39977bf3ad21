"""The plain references against the port at tiny widths on the CPU (the
port's kernels run their plain versions there), in float32 so that both
sides compute the same mathematics to rounding."""

import pytest
import torch

import tiny
from hpcbench import harness
from hpcbench.reference import compare, decoder, work
from hpcbench.reference.data import ZipfTokens


def _model(with_moe: bool, **kw) -> dict:
    m = dict(tiny.TINY_MOE if with_moe else tiny.TINY_DENSE,
             dtype="float32")
    m.update(kw)
    return m


def _port(m: dict):
    return harness.port_config(m, "granite-moe-1b-a400m" if "moe" in m
                               else "yi-6b")


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_prefill_matches_the_port(moe):
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    m = _model(moe)
    params = decoder.make_params(m, 5, "cpu")
    toks = ZipfTokens(m["vocab"], "cpu").draw(5, 0, 2, 48)
    logits, cache = steps.make_prefill_step(
        _port(m), T.ModelOptions(q_chunk=16, kv_chunk=16))(
            params, {"tokens": toks})
    nums = compare.prefill_numbers(params, m, toks, logits,
                                   cache["e0"]["k"], cache["e0"]["v"],
                                   decoder.Numerics())
    assert nums["kv_err"] < 1e-5 and nums["logit_err"] < 1e-5
    assert nums["token_gap"] == 0.0


def test_moe_drops_what_the_port_drops():
    """A capacity factor that drops: the reference works out the same
    kept slots, so the loss and gradients agree."""
    from repro_torch import tree
    from repro_torch.models import transformer as T
    m = _model(True, moe={"n_experts": 8, "top_k": 2,
                          "capacity_factor": 0.5})
    cfg = _port(m)
    params = decoder.make_params(m, 9, "cpu")
    rows = ZipfTokens(m["vocab"], "cpu").draw(9, 0, 2, 33)
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:].to(torch.int32)}
    pp = tree.tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss, _ = T.loss_fn(pp, cfg, batch, opts=T.ModelOptions())
    paths = tree.leaves_with_paths(pp)
    grads = torch.autograd.grad(loss, [x for _, x in paths])
    w = {p: t.clone().requires_grad_(True)
         for p, t in decoder.flat(params).items()}
    rl = decoder.loss(w, m, batch["tokens"], batch["labels"].long(),
                      decoder.Numerics())
    rg = dict(zip(w, torch.autograd.grad(rl, list(w.values()))))
    assert float(loss.detach()) == pytest.approx(float(rl.detach()), rel=1e-6)
    for (p, _), g in zip(paths, grads):
        assert torch.allclose(g, rg[p], rtol=1e-4, atol=1e-6), p


def test_three_train_steps_match_the_port():
    """The donated step's readings (the drivers' set-up) against the
    reference's three steps: losses, first gradients, changes."""
    from hpcbench.drivers import train as train_driver
    import tempfile
    root = tiny.make_root(tempfile.mkdtemp())
    cell = harness.find_cell(root, "tiny.train")
    cell.config["model"] = _model(True)
    prog, batches = train_driver.checked_steps(cell, 11, torch.device("cpu"))
    ref = decoder.train_steps(cell.config["model"],
                              cell.traffic["optimizer"], 11, batches, "cpu",
                              decoder.Numerics())
    nums, _ = compare.train_numbers(prog, ref)
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-4
    assert nums["change_gap"] < 1e-3


def test_fp8_rounds_each_operand():
    a = torch.randn(8, 16, dtype=torch.float64).float()
    b = torch.randn(16, 4).float()
    exact = a @ b
    low = decoder.Fp8().mm(a, b)
    err = compare.rel_err(low, exact)
    assert 0.005 < err < 0.2


def test_zipf_rule_folds_the_tail():
    """The folded Zipf(1.3) mass of id 0 is zeta(1.3, 1/V) / V^1.3 of
    the total; the draw follows it."""
    z = ZipfTokens(64, "cpu")
    ids = z.draw(3, 0, 200, 500)
    assert int(ids.max()) < 64 and int(ids.min()) >= 0
    p0 = float(z.cdf[0])
    share = float((ids == 0).double().mean())
    assert abs(share - p0) < 0.01
    assert torch.equal(ids, z.draw(3, 0, 200, 500))
    assert not torch.equal(ids, z.draw(3, 1, 200, 500))


def test_frozen_counts():
    """The flash kernel's work and a prefill's model FLOPs, by hand."""
    fl, nb = work.flash_work(1, 4, 2, 1, 8)
    assert fl == 4.0 * 2 * 10 * 8 and nb == 2.0 * (2 * 4 * 2 * 8 + 2 * 4 * 8)
    m = dict(tiny.TINY_DENSE)
    per = (64 * (4 + 2 * 2) * 16 + 4 * 16 * 64) + 3 * 64 * 128
    want = (2.0 * 3 * 5 * 2 * per + 2.0 * 3 * 64 * 256
            + 2 * 4.0 * 3 * 15 * 4 * 16)
    assert work.prefill_flops(m, 3, 5) == want
    mo = dict(tiny.TINY_MOE)
    per_moe = (64 * 8 * 16 + 4 * 16 * 64) + 64 * 8 + 2 * 3 * 64 * 32
    assert work.train_flops(mo, 1, 4) == (
        6.0 * 4 * (2 * per_moe + 64 * 256) + 3 * 2 * 4.0 * 10 * 4 * 16)
