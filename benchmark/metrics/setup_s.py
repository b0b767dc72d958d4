"""Set-up: from the process's start to the first timed unit of work (loading,
the bank made on the card, the warm call; on a checkout's first run, the
kernels' build)."""


def read(run):
    return run.setup_s
