#!/usr/bin/env python3
"""What the generator's ids and the oracle's parsing cost on the card's
host, each against its plain form, at phase 6's size.

A diagnostic beside ``chip_smoke.py``, whose dataset helpers it uses; it
times host code only and needs no card.  Each pair runs in turns (A, B,
B, A) on the same inputs, and must agree:

- ``make_ids``: the 2,000,000 seeded ids of config #5's dataset (1e6
  campaigns, 1e6 ads), as ``uuid.UUID(int=..., version=4)`` strings
  (plain) and as ``utils/ids.py:make_ids`` formats them (port);
- ``load_ad_mapping_file``: config #5's 1e6-line map, ``json.loads`` a
  line as the port reads it (port) and one scan a line over the lines
  joined into one text (scan, the form ``dostats`` takes; the map does
  not take it, since it was no faster on the card's host);
- ``dostats``: the oracle over config #5's journal (``--events``), a
  line at a time (plain) and the port's chunks, each scanned as one
  text, one value a line (port);
- ``dostats_scan``: the same oracle with each chunk parsed as one JSON
  array of its lines (array: the earlier form, faster only in that it
  skips the check that each value ends at its own line's end, so it
  counted a torn journal that the reference rejects) and as the port
  scans it (scan): what the check costs.

One JSON line per pair with each run's seconds and the medians; ``--out
FILE`` keeps them together.

    python3 chip_gen_probe.py [--events N] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import statistics
import time
import uuid

from chip_smoke import CONFIG5, _config, _generate, _workdir


def plain_make_ids(n: int, rng: random.Random) -> list[str]:
    return [str(uuid.UUID(int=rng.getrandbits(128), version=4))
            for _ in range(n)]


def plain_dostats(path: str, mapping: dict, divisor_ms: int) -> dict:
    acc: dict = {}
    with open(path, "rb") as f:
        for line in f:
            if not line.strip():
                continue
            ev = json.loads(line)
            if ev["event_type"] != "view":
                continue
            campaign = mapping.get(ev["ad_id"])
            if campaign is None:
                continue
            per = acc.setdefault(campaign, {})
            bucket = int(ev["event_time"]) // divisor_ms
            per[bucket] = per.get(bucket, 0) + 1
    return acc


def array_values(lines: list) -> list:
    """A chunk's values by one ``json.loads`` of its lines as one JSON
    array, line by line where that array does not hold one value a line
    (the earlier form of ``gen._json_values``)."""
    kind = type(lines[0]) if lines else None
    if kind in (bytes, str) and all(type(ln) is kind for ln in lines):
        left, sep, right = ((b"[", b",\n", b"]") if kind is bytes
                            else ("[", ",\n", "]"))
        try:
            values = json.loads(left + sep.join(lines) + right)
        except ValueError:
            values = None
        if isinstance(values, list) and len(values) == len(lines):
            return values
    return [json.loads(ln) for ln in lines]


def dostats_with(values, workdir: str, divisor_ms: int, mapping: dict):
    """``gen.dostats`` with its chunks parsed by ``values``."""
    from streambench_tpu_torch.datagen import gen

    saved, gen._json_values = gen._json_values, values
    try:
        return gen.dostats(workdir, divisor_ms, mapping=mapping)
    finally:
        gen._json_values = saved


def scan_load_map(path: str) -> dict:
    from streambench_tpu_torch.datagen.gen import _json_values

    mapping = {}
    with open(path) as f:
        for obj in _json_values([ln for ln in map(str.strip, f) if ln]):
            mapping.update(obj)
    return mapping


def in_turns(name: str, a, b, arms=("plain", "port")) -> dict:
    """``a``, ``b``, ``b``, ``a`` (named ``arms``); both results equal.
    ``saved_s`` is what ``b`` saves against ``a``, medians."""
    runs, results = [], {}
    for arm in (arms[0], arms[1], arms[1], arms[0]):
        t0 = time.perf_counter()
        results[arm] = (a if arm == arms[0] else b)()
        runs.append((arm, time.perf_counter() - t0))
    if results[arms[0]] != results[arms[1]]:
        raise AssertionError(f"{name}: {arms[1]} differs from {arms[0]}")
    line = {"pair": name, "runs": runs}
    for arm in arms:
        line[f"{arm}_s"] = statistics.median(s for x, s in runs if x == arm)
    line["saved_s"] = line[f"{arms[0]}_s"] - line[f"{arms[1]}_s"]
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.utils.ids import make_ids

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--events", type=int, default=1_000_000)
    ap.add_argument("--out")
    args = ap.parse_args()
    n = CONFIG5["jax.num.campaigns"] * (1 + CONFIG5["jax.ads.per.campaign"])
    lines = [in_turns("make_ids", lambda: plain_make_ids(n, random.Random(7)),
                      lambda: make_ids(n, random.Random(7)))]
    workdir = _workdir("gen_probe")
    try:
        cfg = _config(workdir, CONFIG5)
        _, mapping, _, _, gen_s = _generate(
            workdir, cfg, args.events, 7, store=False,
            num_campaigns=cfg.jax_num_campaigns,
            ads_per_campaign=cfg.jax_ads_per_campaign)
        print(json.dumps({"generate_s": gen_s, "events": args.events}),
              flush=True)
        map_path = os.path.join(workdir, gen.AD_TO_CAMPAIGN_FILE)
        lines.append(in_turns("load_ad_mapping_file",
                              lambda: gen.load_ad_mapping_file(map_path),
                              lambda: scan_load_map(map_path),
                              arms=("port", "scan")))
        divisor = cfg.jax_time_divisor_ms
        journal = os.path.join(workdir, gen.KAFKA_JSON_FILE)
        lines.append(in_turns(
            "dostats", lambda: plain_dostats(journal, mapping, divisor),
            lambda: gen.dostats(workdir, divisor, mapping=mapping)))
        lines.append(in_turns(
            "dostats_scan",
            lambda: dostats_with(array_values, workdir, divisor, mapping),
            lambda: gen.dostats(workdir, divisor, mapping=mapping),
            arms=("array", "scan")))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
