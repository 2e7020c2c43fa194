"""Command-line tools of the port: the chunk-cache builder (host only), the
prove profiler and the dummy-proof exporter."""
