"""The port's collective counter (``parallel.collectives``) against the
hand counts that ``tests/test_collectives.py:128-151`` states.

The JAX package reads its counts out of optimized HLO; the port counts
what its fold issues, through the wrappers every collective of the fold
goes through.  Hand model for the exact-count scan on a (data=2,
campaign=2) mesh with global batch B and K stacked batches (every column
gathered as int32, scalars 4 B), ``col = 4 * B``:

- per-batch arm: each folded batch gathers its columns inside the scan
  body (4 unpacked / 2 packed, ``col`` bytes each) plus one scalar sum:
  ``K * (cols * col + 4)`` bytes, ``K * (cols + 1)`` ops a dispatch;
- hoisted arm: the ``[K, B]`` stacks gather ONCE a dispatch (``K * col``
  bytes each) plus ONE scalar sum: ``cols * K * col + 4`` bytes,
  ``cols + 1`` ops, none in the loop.

The (2, 2) counts come from four spawned gloo ranks (one spawn); the
(1, 1) counts from this process.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from streambench_tpu_torch.obs.registry import MetricsRegistry
from streambench_tpu_torch.parallel import collectives
from streambench_tpu_torch.parallel.collectives import CollectiveOp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
K, B, C, W = 3, 32, 16, 8
COL = 4 * B
ARMS = ("perbatch", "hoisted", "packed_perbatch", "packed_hoisted")

RANK_PROGRAM = r'''
import json, sys
import numpy as np
import torch

def arm_reports(mesh, K, B, C, W):
    """Each scan arm's report over one dispatch of zero [K, B] stacks."""
    from streambench_tpu_torch.parallel import collectives
    from streambench_tpu_torch.parallel import sharded as S
    jt = torch.zeros(65, dtype=torch.int32)
    z = lambda: torch.zeros((K, B), dtype=torch.int32)
    ucols = (z(), z(), z(), torch.zeros((K, B), dtype=torch.bool))
    out = {}
    for hoist, arm in ((False, "perbatch"), (True, "hoisted")):
        out[arm] = collectives.report_for(
            lambda rec: S.sharded_scan(mesh, S.sharded_init_state(C, W, mesh),
                                       jt, *ucols, hoist=hoist,
                                       recorder=rec), scan_len=K)
        out["packed_" + arm] = collectives.report_for(
            lambda rec: S.sharded_scan_packed(
                mesh, S.sharded_init_state(C, W, mesh), jt, z(), z(),
                hoist=hoist, recorder=rec), scan_len=K)
    return out

def engine_report(mesh):
    """``collective_report(k=2)`` of the engine, with obs attached on
    rank 0: the report and the collective gauges."""
    from streambench_tpu_torch.config import default_config
    from streambench_tpu_torch.obs.registry import MetricsRegistry
    from streambench_tpu_torch.parallel import ShardedWindowEngine
    cfg = default_config(jax_batch_size=64, jax_window_slots=16)
    mapping = {f"ad{i}": f"c{i % 4}" for i in range(16)}
    eng = ShardedWindowEngine(cfg, mapping, mesh, device="cpu")
    if mesh.rank != 0:
        eng.follow()
        return None
    reg = MetricsRegistry()
    eng.attach_obs(reg)
    rep = eng.collective_report(k=2)
    eng.close()
    gauges = {m.name + "/" + m.labels.get("kernel", ""): m.value
              for m in reg.collect()
              if m.name.startswith("streambench_collective")}
    return {"report": rep, "gauges": gauges}

if __name__ == "__main__":
    sys.path.insert(0, sys.argv[1])
    torch.set_num_threads(1)
    from streambench_tpu_torch.parallel import build_mesh
    mesh = build_mesh(2, 2, device="cpu", timeout_s=120)
    arms = arm_reports(mesh, *map(int, sys.argv[2:6]))
    eng = engine_report(mesh)
    if mesh.rank == 0:
        print(json.dumps({"arms": arms, "engine": eng}), flush=True)
    # leave together: a rank that exits with its groups alive can abort
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh2x2():
    """Rank 0's JSON from four spawned gloo ranks on a (2, 2) mesh."""
    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(4):
        env = dict(os.environ, PYTHONPATH=REPO,
                   STREAMBENCH_COORDINATOR=coord,
                   STREAMBENCH_NUM_PROCESSES="4",
                   STREAMBENCH_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_PROGRAM, REPO, *map(str, (K, B, C,
                                                                 W))],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return json.loads(outs[0].strip().splitlines()[-1])


@pytest.fixture(scope="module")
def mesh1x1():
    """The same arms on a (1, 1) mesh in this process."""
    ns = {"__name__": "rank_program"}
    exec(compile(RANK_PROGRAM, "rank_program", "exec"), ns)
    from streambench_tpu_torch.parallel import build_mesh

    try:
        return ns["arm_reports"](build_mesh(1, 1, device="cpu"), K, B, C, W)
    finally:
        dist.destroy_process_group()


HAND = {
    # arm: (ops, bytes, column_ops, ops in one loop iteration)
    "perbatch": (K * 5, K * (4 * COL + 4), K * 4, 5),
    "hoisted": (5, 4 * K * COL + 4, 4, 0),
    "packed_perbatch": (K * 3, K * (2 * COL + 4), K * 2, 3),
    "packed_hoisted": (3, 2 * K * COL + 4, 2, 0),
}


@pytest.mark.parametrize("arm", ARMS)
def test_scan_arms_match_hand_computed_costs_at_2x2(mesh2x2, arm):
    ops, nbytes, col_ops, loop_ops = HAND[arm]
    r = mesh2x2["arms"][arm]
    assert r["per_dispatch"]["ops"] == ops
    assert r["per_dispatch"]["bytes"] == nbytes
    assert r["per_dispatch"]["column_ops"] == col_ops
    assert r["per_loop_iteration"]["ops"] == loop_ops
    assert r["top_level"]["ops"] == ops - K * loop_ops
    assert r["per_dispatch"]["by_kind"] == {
        "all-gather": col_ops, "all-reduce": ops - col_ops}


def test_packed_column_traffic_is_half_the_unpacked(mesh2x2):
    """The ``parallel/sharded.py`` packing claim as a number, over the
    hoisted arms: packed column bytes are exactly half."""
    arms = mesh2x2["arms"]
    assert (arms["packed_hoisted"]["per_dispatch"]["column_bytes"] * 2
            == arms["hoisted"]["per_dispatch"]["column_bytes"]
            == 4 * K * COL)


def test_engine_collective_report_and_gauges_at_2x2(mesh2x2):
    """The engine surface: the packed step gathers 2 columns and sums 1
    scalar; the k=2 scan gathers the [2, B] stacks (twice the step's
    column bytes); the gauges mirror the report."""
    eng = mesh2x2["engine"]
    rep = eng["report"]
    assert rep["packed"] is True and rep["scan_batches"] == 2
    assert rep["step"]["per_dispatch"]["ops"] == 3
    assert rep["scan"]["per_dispatch"]["ops"] == 3
    assert (rep["scan"]["per_dispatch"]["column_bytes"]
            == 2 * rep["step"]["per_dispatch"]["column_bytes"]
            == 2 * 2 * 4 * 64)
    g = eng["gauges"]
    assert g["streambench_collective_ops/scan"] == 3
    assert g["streambench_collective_ops/step"] == 3
    assert (g["streambench_collective_bytes/scan"]
            == rep["scan"]["per_dispatch"]["bytes"] > 0)


@pytest.mark.parametrize("arm", ARMS)
def test_scan_arms_at_1x1_issue_the_same_collectives(mesh1x1, arm):
    """World size 1 still issues every collective (the reference psums
    on a size-1 axis too): the same counts and bytes."""
    ops, nbytes, col_ops, loop_ops = HAND[arm]
    r = mesh1x1[arm]
    assert (r["per_dispatch"]["ops"], r["per_dispatch"]["bytes"],
            r["per_loop_iteration"]["ops"]) == (ops, nbytes, loop_ops)


def test_summarize_splits_loop_and_top_level_ops():
    ops = [CollectiveOp("all-gather", "packed", 384, 2, False),
           *[CollectiveOp(kind, name, n, 2, True)
             for _ in range(3)
             for kind, name, n in (("all-gather", "event_time", 128),
                                   ("all-reduce", "counted", 4))]]
    s = collectives.summarize(ops, scan_len=3)
    assert s["top_level"]["ops"] == 1
    assert s["per_loop_iteration"]["ops"] == 2
    assert s["per_loop_iteration"]["bytes"] == 132
    assert s["per_dispatch"]["ops"] == 1 + 3 * 2
    assert s["per_dispatch"]["bytes"] == 384 + 3 * (128 + 4)
    # the scalar sums are left out of the column accounting
    assert s["per_dispatch"]["column_bytes"] == 384 + 3 * 128
    assert s["per_dispatch"]["column_ops"] == 1 + 3
    assert s["per_dispatch"]["by_kind"] == {"all-gather": 4,
                                            "all-reduce": 3}
    with pytest.raises(ValueError, match="scan_len"):
        collectives.summarize(ops[:3], scan_len=3)


def test_publish_gauges_mirrors_report():
    reg = MetricsRegistry()
    report = {"step": {"per_dispatch": {"ops": 3, "bytes": 100}},
              "scan": {"per_dispatch": {"ops": 5, "bytes": 900}},
              "packed": True}
    collectives.publish_gauges(reg, report)
    vals = {(m.name, m.labels.get("kernel")): m.value
            for m in reg.collect()}
    assert vals[("streambench_collective_ops", "scan")] == 5
    assert vals[("streambench_collective_bytes", "step")] == 100


def test_the_gather_keeps_rank_order_and_gathers_bools_as_int32():
    from streambench_tpu_torch.parallel import build_mesh

    try:
        mesh = build_mesh(1, 1, device="cpu")
        rec = collectives.Recorder()
        x = torch.tensor([[True, False], [False, True]])
        got = collectives.all_gather_last(x, mesh.data_group, rec,
                                          name="valid")
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), [[1, 0], [0, 1]])
        s = collectives.all_reduce_sum(torch.tensor(7, dtype=torch.int32),
                                       mesh.campaign_group, rec,
                                       name="counted", in_loop=True)
        assert int(s) == 7 and s.shape == ()
        assert rec.ops == [CollectiveOp("all-gather", "valid", 16, 1, False),
                           CollectiveOp("all-reduce", "counted", 4, 1,
                                        True)]
    finally:
        dist.destroy_process_group()
