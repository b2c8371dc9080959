"""``chip_smoke.py`` phase 21 (the hllx engine and sharded reach),
rehearsed on the CPU at a small size through the smoke's own code.

Phase 15 keeps a 100,000-event journal, phase 19 a 40,000-event one over
10,000 devices (its second journal 20,000 over 5,000); phase 21 then runs
in full on the CPU: sharded reach on a (1, 1) gloo mesh against 19's
planes and answers, the hllx engine against 15's views, its CPU twin and
its resume, the ops rung at the reference bench's size, and the two
engine CLIs side by side (the sharded one beside a replica process).
The card runs 500,000 and 600,000 events.
"""

import os

import torch

torch.set_num_threads(1)


def test_chip_smoke_phase21_runs_on_the_cpu(tmp_path, monkeypatch):
    import chip_smoke

    def workdir(name):
        path = tmp_path / name
        path.mkdir()
        return str(path)

    monkeypatch.setattr(chip_smoke, "_workdir", workdir)
    monkeypatch.setattr(chip_smoke, "REACH_LIVE_EVENTS", 20_000)
    monkeypatch.setattr(chip_smoke, "REACH_LIVE_USERS", 5_000)
    _, sk = chip_smoke.phase_sketches(100_000, device="cpu", keep=True)
    try:
        _, reach = chip_smoke.phase_reach(device="cpu", events=40_000,
                                          users=10_000, keep=True)
    except BaseException:
        sk["data"].remove()
        raise
    out = chip_smoke.phase_hllx_reach(sk, reach, device="cpu")
    b = out["sharded_reach"]
    assert b["backend"] == "gloo" and b["events"] == 40_000
    assert b["planes_equal_phase19"] and b["answers_equal_unsharded"]
    assert b["collectives_per_dispatch"] == 2 and b["dispatches"] == 2
    assert b["collective_kinds"] == ["all-reduce"]
    assert b["report_query"]["ops"] == 2
    assert b["server"]["served"] == 512 and b["server"]["sharded_evaluator"]
    assert b["server"]["answers_equal_unsharded"]
    assert b["query_device_ms"] == "not measured"
    assert b["query_collectives_device_ms"] == "not measured"
    assert b["kernel_launches"] == {"count_cells": 0, "decode_rows": 0,
                                    "cms_rows": 0}
    h = out["hllx"]
    assert h["f1"] == h["views"] == sk["views"] > 0
    assert h["cpu_equal"] and h["resume"]["equal"]
    assert h["rows"] == 11 * h["campaigns_seen"]
    assert h["profile"]["device_ms_per_dispatch"] == "not measured"
    ops = out["hllx_ops"]
    assert ops["f1_exact"] and ops["events"] > 150_000
    assert ops["distinct_rel_err_max"] < 0.2
    assert ops["log_moment_rel_err_max"] < 0.15
    assert out["hllx_cli"]["equal"] and out["hllx_cli"]["events"] == 100_000
    cli = out["sharded_reach_cli"]
    assert "mesh=1x1 backend=gloo" in cli["engine_up"]
    assert cli["agree_equal_oracle"] and cli["reach_rows_equal"]
    assert cli["ship"]["deltas"] > 0
    assert cli["replica"]["tailer"]["deltas_folded"] > 0
    launches = chip_smoke._hllx_reach_launches(out, "count_cells")
    assert set(launches) == {"hllx_catchup", "hllx_cli",
                             "sharded_reach_catchup", "sharded_reach_cli"}
    assert not any(launches.values())
    # both journals removed
    assert not os.path.exists(str(tmp_path / "smoke_sketch"))
    assert not os.path.exists(str(tmp_path / "smoke_reach"))
