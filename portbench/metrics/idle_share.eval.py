"""Device: the share of the traced window in which no operation ran on
the card, one minus the union of the device operations' intervals (never
their sum) over the window, %. Moves ``iw_samples_per_s``."""


def read(x):
    if x.traffic["kind"] != "iw_eval" or x.trace is None:
        return None
    return 100.0 * (1.0 - x.trace.busy_s() / x.trace.window_s)
