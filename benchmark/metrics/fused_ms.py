"""Mean time of the program's fused-pipeline phase (salt draws, upload,
graph replay, download) per prove, from its phase marks on the host
clock, ms.  Reads the program's PhaseTimer phases whose name starts with
`fused` (plonk/prover.py, plonk/device_prover.py)."""


def read(run):
    return run.phase_mean_ms("fused")
