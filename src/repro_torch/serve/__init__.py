"""Serving engine of the port: continuous batching, contiguous or paged."""
from repro_torch.serve.bucketing import bucket_for, bucket_ladder
from repro_torch.serve.engine import (Completion, PagedServeEngine, Request,
                                      ServeEngine)
from repro_torch.serve.paged import PagedAllocator
from repro_torch.serve.sampling import Greedy, Temperature, TopK

__all__ = ["Completion", "Greedy", "PagedAllocator", "PagedServeEngine",
           "Request", "ServeEngine", "Temperature", "TopK", "bucket_for",
           "bucket_ladder"]
