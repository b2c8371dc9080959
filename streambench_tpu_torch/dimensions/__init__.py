"""The pub/sub query channel and the durable store of the dimensional
family, copied from ``streambench_tpu/dimensions/``: the channel reach
queries arrive on (``PubSubServer``, the ``reach`` verb) and the log the
reach planes are shipped through (``DurableDimensionStore``).  The
family's schema, window kernel and app are not ported yet."""

from streambench_tpu_torch.dimensions.pubsub import (  # noqa: F401
    PubSubClient,
    PubSubServer,
    WebSocketClient,
)
from streambench_tpu_torch.dimensions.store import (  # noqa: F401
    DurableDimensionStore,
)
