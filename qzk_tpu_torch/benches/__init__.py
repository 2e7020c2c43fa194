"""Benchmarks of the port, run on the card: ``python3 -m
qzk_tpu_torch.benches.<name>``."""
