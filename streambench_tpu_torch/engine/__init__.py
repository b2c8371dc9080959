from streambench_tpu_torch.engine.pipeline import AdAnalyticsEngine  # noqa: F401
from streambench_tpu_torch.engine.runner import StreamRunner  # noqa: F401
