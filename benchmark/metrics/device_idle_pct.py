"""The share of the traced window in which no operation ran on the
device: one minus the union of the device operations' intervals over the
window's length."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
