"""From the process's start to the first timed request: the imports, the
card's context, the kernel libraries and plans (built in a checkout's
first run, loaded from ``build/`` after it), the tables made on the card,
and the warm-up."""


def read(run):
    return run.setup_s
