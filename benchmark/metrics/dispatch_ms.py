"""Host ms per unit of work (step or track) from the call of the entry to its
return, before any synchronize: the mean over every unit of the window."""


def read(run):
    if not run.dispatch_s:
        return None
    return sum(run.dispatch_s) / len(run.dispatch_s) * 1e3
