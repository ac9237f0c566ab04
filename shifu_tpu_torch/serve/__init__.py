from .batcher import MicroBatcher, Ticket  # noqa: F401
from .registry import ModelRegistry  # noqa: F401
from .scorer import (AOTScorer, DEFAULT_BUCKETS, bucket_ladder,  # noqa: F401
                     covering_bucket, infer_dims, refine_ladder,
                     serve_capture_count)
from .server import ServeServer, max_delay_s, run_serve  # noqa: F401
from .transform import FusedTransform  # noqa: F401
