"""Device time a step in the traced slice: the union of every device
operation's interval between the slice's markers, over its steps.  The
step's own work, steady where the window's rate swings with the gaps
between kernels."""


def read(ctx):
    tr = ctx["traced"]
    if tr is None:
        return None
    return 1e3 * tr["busy_s"] / tr["steps"]
