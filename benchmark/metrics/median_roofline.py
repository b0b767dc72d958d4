"""The least time of a unit's median calls at the device memory's rate (or the
float32 rate, whichever bounds), ``benchmark/roofline.py``, over the device time
the traced slice spent in the median class per unit, in %."""


def read(run):
    if run.trace is None or run.median_bound_us is None:
        return None
    spent = run.trace.per_unit_us("median")
    if spent <= 0.0:
        return None
    return 100.0 * run.median_bound_us / spent
