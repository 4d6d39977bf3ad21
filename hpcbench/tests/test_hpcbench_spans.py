"""The readers of the program's spans and counters (``moe_drop_pct.train``,
``prof_deferred_between_ms.prefill``, ``idle_in_spans_ms.prefill``):
silent on a record that holds nothing for them, a number where it does."""
import importlib.util
import os

import pytest
import torch

from conftest import ROOT

NEW = ("moe_drop_pct.train", "prof_deferred_between_ms.prefill",
       "idle_in_spans_ms.prefill")


def reader(name):
    path = os.path.join(ROOT, "hpcbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


EMPTY = [{}, {"kind": "train"}, {"kind": "prefill"},
         {"kind": "prefill", "counters": {}, "trace": None},
         {"kind": "train", "trace": {"units": 1, "idle_gaps": []}},
         {"kind": "prefill", "counters": {"dispatches": 3,
                                          "deferred_ns": 9}}]


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("rec", EMPTY)
def test_nothing_to_read_is_none(name, rec):
    from repro_torch.models import moe
    moe.reset_dispatch_counts()
    assert reader(name)(rec) is None


def test_drop_share_reads_the_counters():
    from repro_torch.models import moe
    moe.reset_dispatch_counts()
    g = torch.Generator().manual_seed(0)
    params = moe.init_moe_params(g, 8, 4, 4, torch.float32)
    params["router"][:, 0] += 2.0
    x = torch.randn(1, 16, 8, generator=g).abs()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        moe.moe_ffn(params, x, n_experts=4, top_k=2, capacity_factor=1.0)
    c = moe.dispatch_counts()
    got = reader("moe_drop_pct.train")({"kind": "train",
                                        "trace": {"units": 1}})
    assert c["dropped"] > 0 and got == 100.0 * c["dropped"] / c["routed"]
    moe.reset_dispatch_counts()


def test_between_and_span_idle_read_their_fields():
    rec = {"kind": "prefill",
           "counters": {"dispatches": 4, "deferred_ns": 8_000_000,
                        "deferred_between_ns": 6_000_000},
           "trace": {"units": 2, "idle_gaps": [
               ["rt.attn", 0.010], ["repro_torch::flash_attention", 0.5],
               ["rt.kernel:prefill", 0.004], ["(no host event)", 0.2]]}}
    assert reader("prof_deferred_between_ms.prefill")(rec) == 1.5
    assert reader("idle_in_spans_ms.prefill")(rec) == pytest.approx(7.0)
