"""Command-line tools of the port: the chunk-cache builder (host only) and the prove profiler."""
