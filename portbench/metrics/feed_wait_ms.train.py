"""Data layer: the harness's wait in ``next()`` on the program's
``ChunkPrefetcher`` (the batches a thread stacks while the card runs), ms
a step over the traced window. Moves ``train_examples_per_s``."""


def read(x):
    if x.traffic["kind"] != "train" or not x.units:
        return None
    return 1e3 * x.feed_wait_s / x.units
