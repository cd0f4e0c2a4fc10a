"""``python -m repro_torch.launch.serve`` against ``repro.launch.serve`` on
the single-replica argvs of the verify recipe.  The two packages draw
different random weights from the same seed, but the scheduler's clock and
decisions depend on token counts only, so the output JSON must be equal in
every key except wall-clock speed (``tokens_per_s``, ``seconds``) and the
reference's jit count (``decode_compile_count``), which the port does not
report.  With ``--trace-out`` the port's trace also holds one ``exec``
instant per executed leg: it runs every plan eagerly, where the reference
runs the engine's plans inside jit and marks none of them.  Without those
instants the two traces are equal, event for event."""
import json

import pytest
import torch

from repro.launch.serve import main as r_main
from repro_torch import movement as P_MV
from repro_torch.launch.serve import main as p_main

WALL_CLOCK = ("tokens_per_s", "seconds", "decode_compile_count")


@pytest.mark.parametrize("argv", [
    ["--requests", "4", "--resumes", "6"],
    ["--requests", "8", "--followups", "12", "--fork-prefix", "24"],
    ["--requests", "6", "--followups", "10", "--bursty", "--trace-out"],
], ids=["resumes", "fork", "trace"])
def test_launcher_json_matches_reference(argv, tmp_path):
    base = ["--arch", "tinyllama-1.1b", "--reduced"] + argv
    traced = argv[-1] == "--trace-out"
    r_argv = base + ([str(tmp_path / "ref.json")] if traced else [])
    p_argv = base + ([str(tmp_path / "port.json")] if traced else [])
    want = r_main(r_argv)
    got = p_main(p_argv + ["--device", "cpu"])
    assert "decode_compile_count" not in got
    if traced:
        trace = got["trace"]
        assert trace.pop("chrome_trace") == str(tmp_path / "port.json")
        want["trace"].pop("chrome_trace")
        n_exec = trace["per_phase"].pop("exec")
        assert n_exec > 0 and "exec" not in want["trace"]["per_phase"]
        trace["spans"] -= n_exec
        events = json.loads((tmp_path / "port.json").read_text())
        ran = [e for e in events["traceEvents"] if e.get("cat") == "exec"]
        assert len(ran) == n_exec
        events["traceEvents"] = [e for e in events["traceEvents"]
                                 if e.get("cat") != "exec"]
        assert events == json.loads((tmp_path / "ref.json").read_text())
    assert P_MV.registry._TRACER is None
    assert ({k: v for k, v in got.items() if k not in WALL_CLOCK}
            == {k: v for k, v in want.items() if k not in WALL_CLOCK})


@pytest.mark.parametrize("flags", [
    ["--replicas", "2"], ["--fault-rate", "0.1"], ["--fault-seed", "3"],
    ["--no-recovery"], ["--snapshot-every", "2"], ["--no-migrate"],
])
def test_cluster_flags_name_the_cluster_slice(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        p_main(["--device", "cpu", "--arch", "tinyllama-1.1b", "--reduced"]
               + flags)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert flags[0] in err and "cluster and faults slice" in err


def test_launcher_needs_a_gpu_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p_main(["--arch", "tinyllama-1.1b", "--reduced", "--requests", "1"])
