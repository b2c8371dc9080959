"""Dimensional schema: the ``eventSchema.json`` contract as a dataclass.

A copy of ``streambench_tpu/dimensions/schema.py``.  The reference
declares its dimensional cube in JSON
(``apex-benchmarks/src/main/resources/eventSchema.json``): key fields, time
buckets ("10s"), value fields with aggregator lists (clicks:SUM,
latency:MAX), and key combinations (["campaignId"]).  The Apex engine
interprets it reflectively via POJO field expressions
(``ApplicationDimensionComputation.java:96-116``); here it compiles to
static shapes — each (combination, value, aggregator) triple becomes one
dense device array in ``DimensionState``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

# aggregator -> (scatter kind, identity element for int64 accumulation)
AGGREGATORS: dict[str, tuple[str, int]] = {
    "SUM": ("add", 0),
    "COUNT": ("count", 0),
    "MAX": ("max", -(2**62)),
    "MIN": ("min", 2**62),
}

_TIME_UNITS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000}


def parse_time_bucket(spec: str) -> int:
    """'10s' / '200ms' / '1m' -> milliseconds."""
    for unit in sorted(_TIME_UNITS, key=len, reverse=True):
        if spec.endswith(unit):
            head = spec[:-len(unit)]
            if head.isdigit():
                return int(head) * _TIME_UNITS[unit]
    raise ValueError(f"unparseable time bucket {spec!r}")


@dataclass(frozen=True)
class ValueSpec:
    name: str
    aggregators: tuple[str, ...]


@dataclass(frozen=True)
class DimensionalSchema:
    keys: tuple[str, ...]                    # all declared key fields
    time_bucket_ms: int                      # first (primary) time bucket
    values: tuple[ValueSpec, ...]
    combinations: tuple[tuple[str, ...], ...]  # key subsets to cube over

    def aggregate_slots(self) -> list[tuple[str, str]]:
        """The (value, aggregator) pairs, in declaration order — one state
        array per pair per combination."""
        return [(v.name, a) for v in self.values for a in v.aggregators]

    def validate(self) -> None:
        for v in self.values:
            for a in v.aggregators:
                if a not in AGGREGATORS:
                    raise ValueError(f"unsupported aggregator {a!r} "
                                     f"for value {v.name!r}")
        for combo in self.combinations:
            unknown = set(combo) - set(self.keys)
            if unknown:
                raise ValueError(f"combination {combo} uses undeclared "
                                 f"keys {sorted(unknown)}")


def parse_schema(src: str | dict) -> DimensionalSchema:
    """Parse an eventSchema.json-shaped document (string or dict).

    Tolerates trailing commas (the reference's own schema file has one
    after the campaignId key entry)."""
    if isinstance(src, str):
        src = json.loads(_strip_trailing_commas(src))
    keys = tuple(k["name"] for k in src.get("keys", []))
    buckets = src.get("timeBuckets") or ["10s"]  # absent OR empty -> 10s
    values = tuple(ValueSpec(v["name"], tuple(v.get("aggregators", ["SUM"])))
                   for v in src.get("values", []))
    combos = tuple(tuple(c["combination"])
                   for c in src.get("dimensions", [])) or (keys,)
    schema = DimensionalSchema(
        keys=keys,
        time_bucket_ms=parse_time_bucket(buckets[0]),
        values=values,
        combinations=combos,
    )
    schema.validate()
    return schema


def _strip_trailing_commas(text: str) -> str:
    out: list[str] = []
    in_str = False
    for i, ch in enumerate(text):
        if ch == '"' and (i == 0 or text[i - 1] != "\\"):
            in_str = not in_str
        if not in_str and ch in "]}":
            # drop a dangling comma before a closer
            j = len(out) - 1
            while j >= 0 and out[j] in " \t\r\n":
                j -= 1
            if j >= 0 and out[j] == ",":
                del out[j]
        out.append(ch)
    return "".join(out)
