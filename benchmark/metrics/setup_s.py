"""setup_s (s): from the process's start to the first timed query: the
card's start-up, the seeded inputs, the program's build and the warm-up."""


def read(run):
    return run.setup_s
