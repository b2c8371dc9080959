#!/usr/bin/env python3
"""K2's launch-plan sweep on one CUDA card (a diagnostic, not part of the
smoke).

Times the decode kernel K2 (``streambench_tpu_torch/csrc/decode_rows.cu``)
under launch plans beside the one ``ops/decode.py:decode_plan`` picks, on
``chip_smoke.py``'s own K2 inputs (same kinds, same seeds): blocks of 32,
64, 128 and 256 threads, one row a thread; the slot table staged in shared
memory (smem tier) or read from global memory (global tier).  Every plan's
four outputs are first held against the plain version exactly (max
|diff| 0); device times are ``chip_smoke._device_ms``'s (CUDA-graph
replays between CUDA events).  Prints one JSON line per case and, with ``--out``, writes
them all to a file::

    python3 chip_decode_probe.py [--out build/decode_probe.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
# the chip_smoke.py cases swept: the main dispatch, the deep case, a scan
# group and a full journal block, the global tier's table, the bandwidth
# case
KINDS = ("halfbatch", "deep", "generator", "bigtable", "tiled")
THREADS = (32, 64, 128, 256)


def sweep_case(cs, label: str, groups: int, B: int, kind: str, seed: int,
               sms: int) -> dict:
    import numpy as np
    import torch

    from streambench_tpu_torch.ops import decode as tdec

    case = cs._decode_inputs(seed, groups, B, kind)
    base = case["base"]
    buf = torch.from_numpy(case["storage"]).cuda()[case["offset"]:]
    starts, lens, keys, vals = (torch.from_numpy(case[k]).cuda() for k in
                                ("starts", "lens", "keys", "vals"))
    meta = torch.from_numpy(tdec.slot_meta(case["keys"], case["vals"],
                                           case["used"]).view(np.int32)).cuda()
    hi, lo = base // 1_000_000_000, base % 1_000_000_000
    want = tdec.decode_rows_plain(buf, starts, lens, keys, vals,
                                  case["probes"], hi, lo)
    T, rows = keys.shape[0], groups * B
    chosen = tdec.decode_plan(T, buf.shape[0], buf.data_ptr() % 16, rows,
                              sms=sms)
    tiers = ["global"] + (["smem"] if chosen.tier == "smem" else [])
    outs = tuple(torch.empty_like(w) for w in want)
    results = []
    for tier in tiers:
        for threads in THREADS:
            blocks = -(-rows // threads)
            plan = tdec._PlanArgs(tier == "smem", threads, blocks,
                                  tdec.meta_bytes(T) if tier == "smem" else 0,
                                  chosen.vector)

            def launch(plan=plan):
                tdec._launch(buf, starts, lens, keys, meta, case["probes"],
                             hi, lo, outs,
                             torch._C._cuda_getCurrentRawStream(
                                 buf.get_device()), plan)

            launch()
            torch.cuda.synchronize()
            diff = max(int((o.long() - w.long()).abs().max().item())
                       for o, w in zip(outs, want))
            if diff:
                raise AssertionError(f"{label}: plan {tier} {threads} x "
                                     f"{blocks} differs: {diff}")
            results.append({"tier": tier, "threads": threads,
                            "blocks": blocks, "ms": cs._device_ms(launch)})
    best = min(results, key=lambda r: r["ms"])
    mine = next(r for r in results if r["tier"] == chosen.tier
                and r["threads"] == chosen.threads
                and r["blocks"] == chosen.blocks)
    return {"case": label, "inputs": kind, "rows": rows, "table_slots": T,
            "chosen": chosen._asdict(), "chosen_ms": mine["ms"],
            "best": best, "plans": results}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every case to this JSON file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_decode_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    from streambench_tpu_torch.ops.count import device_limits

    smi = cs.phase_device()
    sms, _ = device_limits(0)
    out = []
    for i, (label, groups, B, kind) in enumerate(cs.DECODE_CASES):
        if kind not in KINDS:
            continue
        res = sweep_case(cs, label, groups, B, kind, 100 + i, sms)
        out.append(res)
        print(json.dumps({k: v for k, v in res.items() if k != "plans"}),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "cases": out}, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
