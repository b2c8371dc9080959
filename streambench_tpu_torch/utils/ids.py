"""Identifier and clock helpers shared across the framework.

The reference identifies campaigns/ads/users/pages by random UUID strings
(``data/src/setup/core.clj:20-22``, ``JsonGenerator.java:111-124``).  We keep
that wire format — the engine interns strings to dense int32 ids at ingest.
"""

from __future__ import annotations

import random
import time
import uuid


def make_ids(n: int, rng: random.Random | None = None) -> list[str]:
    """``n`` random UUID strings (``core.clj:20-22``: ``make-ids``).

    A seeded ``rng`` gives deterministic ids for the catchup/golden-model
    datasets while staying UUID-shaped on the wire.
    """
    if rng is None:
        return [str(uuid.uuid4()) for _ in range(n)]
    return [str(uuid.UUID(int=rng.getrandbits(128), version=4)) for _ in range(n)]


def now_ms() -> int:
    """Wall clock in integer milliseconds (``System.currentTimeMillis`` analog)."""
    return time.time_ns() // 1_000_000
