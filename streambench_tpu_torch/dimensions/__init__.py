"""Dimensional aggregation family (the Apex dimension-computation peer).

The port of ``streambench_tpu/dimensions/``: a declarative dimensional
schema (``eventSchema.json`` shape), the multi-aggregate window fold
(SUM/MAX/MIN/COUNT per key per time bucket on the device; the presence
plane and COUNT through the count kernel K1), a durable append-log store
with the latency-aware decile report, and a JSON-lines pub/sub query
channel (the WebSocket gateway analog, which also carries reach queries).
"""

from streambench_tpu_torch.dimensions.app import (  # noqa: F401
    SENTINEL_CAMPAIGN,
    DimensionApp,
)
from streambench_tpu_torch.dimensions.compute import (  # noqa: F401
    DimensionState,
    DimensionsComputation,
    KeyInterner,
)
from streambench_tpu_torch.dimensions.pubsub import (  # noqa: F401
    PubSubClient,
    PubSubServer,
    WebSocketClient,
)
from streambench_tpu_torch.dimensions.schema import (  # noqa: F401
    AGGREGATORS,
    DimensionalSchema,
    parse_schema,
)
from streambench_tpu_torch.dimensions.store import (  # noqa: F401
    DurableDimensionStore,
)
