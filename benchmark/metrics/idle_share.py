"""The share of the traced window in which no kernel or copy ran on the card, in %."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0.0 or run.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
