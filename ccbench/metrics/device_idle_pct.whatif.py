"""Percent of the traced what-if requests' window in which no operation ran
on the card: 1 - the union of the device operations' intervals over the
window."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return run.trace.idle_pct
