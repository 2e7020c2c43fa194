"""Set-up: from the start of the process to the first timed request
(library loads, circuit artifacts and chunk-circuit blobs, device
contexts, graph captures, the pool and the warm-up), host clock, s."""


def read(run):
    return run.setup_s
