"""Device time per step, in the traced slice, of every operation that is
neither a matrix product nor one of the port's flash kernels: elementwise
work, norms, softmax, sorts, gathers and scatters, copies, the optimizer
(classes in ``harness/kernel_classes.json``)."""


def read(ctx):
    tr = ctx["traced"]
    if tr is None:
        return None
    other = sum(s for cls, (s, _) in tr["by_class"].items() if cls not in ("gemm", "flash_fwd", "flash_bwd"))
    return 1e3 * other / tr["steps"]
