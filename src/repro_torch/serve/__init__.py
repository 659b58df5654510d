from .engine import Overloaded, Request, ServeEngine
from .kv_pages import PageAllocator, PagedKV, PagesExhausted, pages_for
from .buckets import CostModel, bucket_for, make_buckets

__all__ = ["Overloaded", "Request", "ServeEngine",
           "PageAllocator", "PagedKV", "PagesExhausted", "pages_for",
           "CostModel", "bucket_for", "make_buckets"]
