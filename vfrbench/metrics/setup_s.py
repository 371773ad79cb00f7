"""setup_s: seconds from the process's start to the window's first call:
imports, the CUDA context, the kernels' build (the first run of a
checkout compiles them), seeded weights and inputs on the card, the
port's set-up and the warm-up (graph captures, the train cell's first
steps)."""

UNIT = "s"
TRACED = False


def read(rec):
    return rec["setup_s"]
