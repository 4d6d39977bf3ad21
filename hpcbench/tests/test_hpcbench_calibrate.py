"""The calibration script's readings, rehearsed on tiny cells on the
CPU: one JSON line a reading, the program's on every seed, the
control's (and, for training, half a batch's) on the first."""
import json

import pytest

import tiny
from hpcbench import calibrate


@pytest.mark.parametrize("name,sides", [
    ("tiny.prefill", ["program", "control_fp8", "program"]),
    ("tiny.train", ["program", "control_fp8", "fault_half_batch",
                    "program"])])
def test_readings(tmp_path, capsys, name, sides):
    root = tiny.make_root(str(tmp_path))
    assert calibrate.main(["--workload", name, "--seeds", "2",
                           "--control", "1", "--root", root,
                           "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["side"] for x in lines] == sides
    prog = [x["numbers"] for x in lines if x["side"] == "program"]
    low = [x["numbers"] for x in lines if x["side"] == "control_fp8"][0]
    key = "kv_err" if name == "tiny.prefill" else "loss_gap"
    assert low[key] > 3 * max(p[key] for p in prog)
