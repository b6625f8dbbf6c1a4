"""``setup_s``: from the start of the run's work to the window's start:
imports, the kernel library's load (and build, in a checkout's first run),
the inputs made from the seed, the program's set-up and warm-up."""


def read(rec):
    return rec.get("setup_s")
