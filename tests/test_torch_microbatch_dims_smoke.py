"""``chip_smoke.py`` phase 22 (the micro-batch mode, the handoff and the
dimensional family), rehearsed on the CPU at a small size through the
smoke's own code.

(a) runs a 60,000-event journal at the stock ``window.size: 5000`` over
``map.partitions: 3`` (12 windows of 3 x 1,666 events; checkpoints every
4 windows), (c) 50,000 synthetic events at 1M campaigns into 2^20 keys
and the app over partition 0 of (a)'s topic, and both CLIs run as
processes.  The card runs 1,500,000 and 2,000,000 events.
"""

import json
import os

import torch

torch.set_num_threads(1)


def test_chip_smoke_phase22_runs_on_the_cpu(tmp_path, monkeypatch):
    import chip_smoke

    def workdir(name):
        path = tmp_path / name
        path.mkdir()
        return str(path)

    monkeypatch.setattr(chip_smoke, "_workdir", workdir)
    monkeypatch.setattr(chip_smoke, "MB_CHECKPOINT_EVERY", 4)
    monkeypatch.setattr(chip_smoke, "DIMS_CLI_EVENTS", 20_000)
    out = chip_smoke.phase_microbatch_dims(device="cpu", mb_events=60_000,
                                           dims_events=50_000)
    json.dumps(out)                        # what --out writes
    a = out["microbatch"]
    assert (a["windows"], a["partitions"], a["rows_per_window"]) == (
        12, 3, 1666)
    assert a["exact"]["kernel_launches"] == {
        "count_cells": 0, "decode_rows": 0, "cms_rows": 0}  # CPU: plain
    assert a["cpu_equal"] and a["hll"]["registers_equal_cpu"]
    assert a["hll"]["estimate_max_diff"] == 0
    assert a["redis"]["windows"] == 12
    assert a["resume"]["stopped_at"] == 11 and a["cpu_windows"] == 12
    assert a["resume"]["resumed_from"] == 8
    assert a["exact"]["latency_hash"]["thread_idx"] == 3
    assert a["exact"]["total_views"] > 0
    assert a["fold"]["device_ms"] == "not measured"
    assert a["fold"]["rows"] == 1666 and a["fold"]["call_ms"] > 0
    b = out["handoff"]
    assert b["windows"] == 19 and b["batch_size"] == 5000
    assert 0 < b["r2c_ms_p50"] <= b["r2c_ms_max"]
    c = out["dims"]
    assert c["events"] == 50_000 and c["dropped"] == 0
    assert c["steps"] == 7 and c["rows"] > 40_000
    assert c["peak_allocated_bytes"] == "not measured"
    assert 0 < c["intern_share"] < 1 and 0 < c["row_build_share"] < 1
    app = out["dims_app"]
    assert app["events"] == 60_000 and app["rows"] > 0
    assert out["microbatch_cli"]["total_views"] == a["exact"]["total_views"]
    assert out["microbatch_cli"]["windows"] == 12
    assert out["dims_cli"]["events"] == 20_000
    launches = chip_smoke._microbatch_dims_launches(out, "count_cells")
    assert set(launches) == {"microbatch_exact", "microbatch_hll",
                             "microbatch_redis", "microbatch_resume",
                             "dims_synthetic", "dims_app"}
    assert not os.path.exists(str(tmp_path / "smoke_microbatch"))
