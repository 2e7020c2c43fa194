"""The least time the Poseidon work of the traced window's proofs could
take on the card (harness/work.py, counted from the circuit's shapes and
each proof's nonce), over the device time of K1 and K2 in that window, %.
Reads the program's kernel names `hash_rows_kernel` (K1) and
`permute_kernel` (K2) of ops/csrc/poseidon.cu; a window in which either
ran for no time reads nothing, and a traced run that reads nothing fails."""

from harness import work

K1_K2 = ("hash_rows_kernel", "permute_kernel")


def read(run):
    if run.trace is None or not run.traced_work or run.rates is None:
        return None
    seconds = [run.trace.kernels.get(k, (0.0, 0))[0] for k in K1_K2]
    if min(seconds) <= 0:
        return None
    return 100.0 * work.least_seconds(*run.traced_work, run.rates) / sum(seconds)
