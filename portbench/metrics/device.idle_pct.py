"""The share of the traced slice's wall time (between its two marker
spins, on the card's clock) in which no operation ran on the card."""


def read(ctx):
    tr = ctx["traced"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
