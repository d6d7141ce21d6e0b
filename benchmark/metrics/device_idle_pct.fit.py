"""Device: the share of the traced stretch of a fitting loop in which no
operation ran on the card, in %."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
