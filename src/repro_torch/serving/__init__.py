"""Parked-KV serving: the paged-KV allocator (``pool``) and the
single-shard decode engine that moves only request headers (``engine``)."""
