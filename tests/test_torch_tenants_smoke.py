"""``chip_smoke.py`` phase 23 (the multi-tenant host), rehearsed on the CPU
at a small size through the smoke's own code.

(a) runs a 50,000-event journal at the stock configuration (7 batches of
8,192 events to each of four tenants), (b) the flash crowd on a 3 s
schedule with 500-event crowd batches, (c) both admission scripts over
6 queued batches a tenant, and (d) the ``--tenants`` CLI as a process.
The card runs 250,000 events and ``bench_multitenant.py``'s smoke
schedule.
"""

import json
import os

import torch

torch.set_num_threads(1)


def test_chip_smoke_phase23_runs_on_the_cpu(tmp_path, monkeypatch):
    import chip_smoke

    def workdir(name):
        path = tmp_path / name
        path.mkdir()
        return str(path)

    monkeypatch.setattr(chip_smoke, "_workdir", workdir)
    monkeypatch.setattr(chip_smoke, "TENANTS_FLASH", dict(
        chip_smoke.TENANTS_FLASH, duration_s=3.0, crowd=(1.0, 2.0),
        steady_n=50, crowd_n=500, qps=10.0))
    monkeypatch.setattr(chip_smoke, "TENANTS_ACTUATOR_BATCHES", 6)
    monkeypatch.setattr(chip_smoke, "TENANTS_ACTUATOR_QUEUE", 4)
    out = chip_smoke.phase_tenants(device="cpu", events=50_000)
    json.dumps(out, default=str)             # what --out writes
    a = out["isolation"]
    assert a["events"] == 50_000 and a["batches"] == 7
    assert a["tenants"] == {"ex": "exact", "se": "session", "hl": "hll",
                            "rc": "reach"}
    # the CPU runs the kernels' plain versions: no launch anywhere
    assert a["kernel_launches"] == a["solo_launches"] == {
        "count_cells": 0, "decode_rows": 0, "cms_rows": 0}
    assert a["partition"]["ok"] and a["oracle"]["differ"] == 0
    assert set(a["attributed_busy_ms"]) == set(a["tenants"])
    assert all(v <= 1 for v in a["max_estimate_diff"].values())
    assert a["wall_s"] > 0 and a["alone_wall_s"] > 0
    # (d) starts after (a)'s timed runs and ends before (b)
    assert list(out["parts_s"]) == ["isolation_runs", "isolation",
                                    "actuator", "flash_world", "cli",
                                    "flash"]
    b = out["flash"]
    for arm in ("off", "on"):
        r = b[arm]
        assert r["partition"]["ok"] and not r["backlog"]
        assert r["replied"] == r["sent"] == 30
        assert r["events"] == b["off"]["events"]
        assert 0.0 <= r["breach_ratio"] <= 1.0
    assert not b["off"]["decisions"]
    c = out["actuator"]
    defer, release = c["defer"]["decisions"]
    assert (defer["decision"], defer["step"], defer["tenant"]) == (
        "defer", 3, "rb")
    assert (release["decision"], release["step"]) == ("release", 8)
    assert [d["decision"] for d in c["shed"]["decisions"]] == ["defer",
                                                              "shed"]
    shed = c["shed"]
    rb = shed["tenants"]["rb"]
    assert shed["offered"] == 6 and rb["dropped_batches"] == 2
    assert 6 == (rb["folded_batches"] + shed["admission"]["batches_shed"]
                 + rb["dropped_batches"])
    assert out["cli"]["engine"] == "multitenant"
    assert {t["events"] for t in out["cli"]["tenants"].values()} == {50_000}
    launches = chip_smoke._tenants_launches(out, "cms_rows")
    assert set(launches) == {"tenants_host", "tenants_alone",
                             "tenants_flash_off", "tenants_flash_on",
                             "tenants_actuator"}
    assert not os.path.exists(str(tmp_path / "smoke_tenants"))
