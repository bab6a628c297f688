from .engine import EngineMetrics, PagedServeEngine, ServeEngine
from .paged_cache import NULL_PAGE, OutOfPages, PagedKVCache
from .scheduler import SLO_THROUGHPUT, SLO_TTFT, FifoScheduler, Request
from .server import AsyncServeFrontend, TokenStream

__all__ = ["EngineMetrics", "PagedServeEngine", "ServeEngine", "NULL_PAGE",
           "OutOfPages", "PagedKVCache", "SLO_THROUGHPUT", "SLO_TTFT",
           "FifoScheduler", "Request", "AsyncServeFrontend", "TokenStream"]
