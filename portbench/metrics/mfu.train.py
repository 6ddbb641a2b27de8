"""Model: the training step's conv FLOP (forward and backward, AR convs
over their live taps, no recompute; ``yardstick.model_flops``) over the
traced window's host-clock time, as a share of the card's published
dense peak in the configuration's precision, %. Moves
``train_examples_per_s``."""

from portbench import yardstick as y


def read(x):
    if x.traffic["kind"] != "train" or not x.units:
        return None
    flops = y.model_flops(x.c, x.traffic["batch_size"], train=True) * x.units
    return 100.0 * flops / x.window_s / y.PEAK_FLOPS[y.peak_dtype(x.c)]
