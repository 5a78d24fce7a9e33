"""Seconds to batch, pad and stack the train pools and the eval stacks on
the card in set-up (a span that ends in a synchronize)."""


def read(r):
    return r["spans"].get("pool_build")
