"""The control of each cell's comparison comes out not correct: the
reference computed in float8, the precision below the configurations'
bf16, put in the program's place and held to the cell's own limits, at
tiny widths on the CPU.  (At the cells' sizes it runs on the card:
``python3 hpcbench/calibrate.py --workload <cell> --control 3``.)"""
import json
import os

import pytest

import tiny
from hpcbench.reference import compare, decoder
from hpcbench.reference.data import ZipfTokens


def _limits(cell: str) -> dict:
    with open(os.path.join(tiny.BENCH, "limits", cell + ".json")) as f:
        return json.load(f)["numbers"]


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_prefill_control_fails(seed):
    m = dict(tiny.TINY_DENSE)
    params = decoder.make_params(m, seed, "cpu")
    toks = ZipfTokens(m["vocab"], "cpu").draw(seed, 0, 2, 64)
    ks, vs = [], []
    low = decoder.prefill(params, m, toks, decoder.Fp8(),
                          lambda i, k, v: (ks.append(k), vs.append(v)))
    nums = compare.prefill_numbers(params, m, toks, low, ks, vs,
                                   decoder.Numerics())
    ok, shown = compare.judge(nums, _limits("yi6b.prefill4k.prof"))
    assert not ok, shown


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_train_control_fails(seed):
    m = dict(tiny.TINY_MOE)
    with open(os.path.join(tiny.BENCH, "traffic", "train1k.json")) as f:
        opt = json.load(f)["optimizer"]
    rows = ZipfTokens(m["vocab"], "cpu")
    batches = []
    for i in range(3):
        r = rows.draw(seed, i, 2, 65)
        batches.append((r[:, :-1], r[:, 1:]))
    ref = decoder.train_steps(m, opt, seed, batches, "cpu",
                              decoder.Numerics())
    low = decoder.train_steps(m, opt, seed, batches, "cpu", decoder.Fp8())
    nums, _ = compare.train_numbers(low, ref)
    ok, shown = compare.judge(nums, _limits("granite.train1k"))
    assert not ok, shown


def test_a_state_left_unchanged_reads_one():
    ref = {"loss": [1.0], "grad": {"a": 1.0, "b": 2.0},
           "change": {"a": 0.5, "b": 0.7}}
    prog = dict(ref, change={"a": 0.0, "b": 0.0})
    nums, _ = compare.train_numbers(prog, ref)
    assert nums["change_gap"] == pytest.approx(1.0)
