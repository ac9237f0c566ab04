from .batcher import MicroBatcher, Ticket  # noqa: F401
from .registry import ModelRegistry  # noqa: F401
from .scorer import (AOTScorer, DEFAULT_BUCKETS, bucket_ladder,  # noqa: F401
                     covering_bucket, infer_dims)
from .server import ServeServer, run_serve  # noqa: F401
