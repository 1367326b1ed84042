"""paddle_tpu_torch.serving — online inference on the card: bucketed
batch shapes, dynamic micro-batching, bounded admission, metrics.

Counterpart of paddle_tpu/serving, for dense and ragged (LoD) feeds:
  * shape bucketing — every batch pads up to a configured bucket, so
    the card sees a small, warmable set of shapes
    (`engine.InferenceEngine`);
  * dynamic micro-batching — concurrent requests coalesce up to
    `max_batch`/`max_wait_ms` into one run (`batcher.MicroBatcher`);
  * backpressure — a bounded admission queue sheds load (429), expired
    deadlines answer 504, a draining server 503
    (`server.InferenceServer`);
  * metrics — per-stage latency histograms, queue depth, batch
    occupancy, bucket hit/miss (`metrics`, `/metrics`).
"""

from . import metrics
from .batcher import (BatcherConfig, DeadlineExceededError, MicroBatcher,
                      QueueFullError, ServingError, ShuttingDownError)
from .engine import EngineConfig, InferenceEngine
from .server import InferenceServer, ServerConfig

__all__ = [
    "InferenceEngine", "EngineConfig", "MicroBatcher", "BatcherConfig",
    "InferenceServer", "ServerConfig", "metrics", "ServingError",
    "QueueFullError", "DeadlineExceededError", "ShuttingDownError",
]
