"""Small sizes of the benchmark's cells for the CPU tests: the cell's own
configuration and traffic with every width and count cut down."""

from portbench.harness.spec import Spec

SPEC = Spec()
SEED = 2**31 + 11


def overrides(workload):
    cell = SPEC.cell(workload)
    cfg = dict(SPEC.config(cell["config"]), d_model=64, n_heads=2, d_ff=128, n_layers=2,
               max_len=32)
    traffic = dict(SPEC.traffic(cell["traffic"]), seq_len=32, batch=4)
    traffic["pool_batches"] = 4
    return {"config": cfg, "traffic": traffic}
