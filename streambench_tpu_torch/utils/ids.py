"""Identifier and clock helpers shared across the framework.

The reference identifies campaigns/ads/users/pages by random UUID strings
(``data/src/setup/core.clj:20-22``, ``JsonGenerator.java:111-124``).  We keep
that wire format — the engine interns strings to dense int32 ids at ingest.
"""

from __future__ import annotations

import random
import time
import uuid


_V4_CLEAR = ~((0xf000 << 64) | (0xc000 << 48))
_V4_SET = (4 << 76) | (0x8000 << 48)


def make_ids(n: int, rng: random.Random | None = None) -> list[str]:
    """``n`` random UUID strings (``core.clj:20-22``: ``make-ids``).

    A seeded ``rng`` gives deterministic ids for the catchup/golden-model
    datasets while staying UUID-shaped on the wire: the strings of
    ``uuid.UUID(int=rng.getrandbits(128), version=4)``, formatted here
    without building the objects (``chip_gen_probe.py`` times both).
    """
    if rng is None:
        return [str(uuid.uuid4()) for _ in range(n)]
    out = []
    for _ in range(n):
        # the version nibble and the RFC 4122 variant bits, then the
        # 8-4-4-4-12 hex form
        h = "%032x" % (rng.getrandbits(128) & _V4_CLEAR | _V4_SET)
        out.append(f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}")
    return out


def now_ms() -> int:
    """Wall clock in integer milliseconds (``System.currentTimeMillis`` analog)."""
    return time.time_ns() // 1_000_000
