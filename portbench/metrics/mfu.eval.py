"""Model: the IW eval's forward conv FLOP (one forward an importance
sample, AR convs over their live taps; ``yardstick.model_flops``) over
the traced window's host-clock time, as a share of the card's published
dense peak in the configuration's precision, %. Moves
``iw_samples_per_s``."""

from portbench import yardstick as y


def read(x):
    if x.traffic["kind"] != "iw_eval" or not x.samples:
        return None
    flops = y.model_flops(x.c, x.samples, train=False)
    return 100.0 * flops / x.window_s / y.PEAK_FLOPS[y.peak_dtype(x.c)]
