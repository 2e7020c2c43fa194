"""qzk_tpu_torch — the PyTorch + CUDA port of qzk_tpu for NVIDIA Hopper.

It proves and verifies the same circuits as qzk_tpu, byte for byte, with
field elements carried as the uint64 bit patterns of torch.int64
tensors.  The JAX package stays the reference; this package imports
neither it nor JAX.

Layout (mirrors qzk_tpu):
  ops/      — field, Poseidon, NTT, Merkle, the zk threefry stream
              (numpy oracles, torch device code, and the hand-written
              CUDA kernels in ops/csrc)
  plonk/    — circuit builder, witness generation, the fused device
              prover, the host verifier, configs
  models/   — the Wormhole circuit and its session APIs; the voting
              circuit
  benches/  — kernel, SASS and warm zk prove benchmarks
  native/   — host C++ kernels (witness executor, Merkle walk)
  utils/    — codecs, device selection, the native library builds
  convert.py — qzk_tpu CircuitData -> this package's CircuitData

Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
