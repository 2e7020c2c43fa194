"""Mean time of the program's witness phase (commit and generators; in
an aggregation, from the previous chunk prove on, so level hand-offs
count) per prove, from its phase marks on the host clock, ms.  Reads the
program's PhaseTimer phases whose name starts with `witness`
(plonk/prover.py)."""


def read(run):
    return run.phase_mean_ms("witness")
