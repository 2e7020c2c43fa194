"""Mean time of the program's witness generators per prove (the span
`witness.generators`, plonk/witness.py::run_generators: seeding the
partial witness's values, then the generator plan), host clock, ms; a
chunk prove counts as one prove."""

from harness import spans


def read(run):
    return spans.read(run, "witness.generators")
