"""Nothing the harness or the reference loads is JAX or the JAX package
(top-level names compared whole), and the reference loads nothing of the
program."""

import subprocess
import sys

from portbench.harness.cell import forbidden_modules
from portbench.harness.spec import ROOT

PROBE = """
import sys
sys.path.insert(0, {root!r})
{body}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""

TINY_RUN = """
from portbench.harness.spec import Spec
from portbench.harness import cell
spec = Spec()
cfg = dict(spec.config(spec.cell("wm_train")["config"]), d_model=32, n_heads=2, d_ff=64, n_layers=1,
           max_len=16)
traffic = dict(spec.traffic("episode_pool"), seq_len=16, batch=2, pool_batches=3)
res = cell.run(spec, "wm_train", 5, 0.2, False, device="cpu",
               overrides={"config": cfg, "traffic": traffic})
assert res["leaked"] == []
"""


def _tops(body):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), body=body)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_portbench_whole_names_tell_the_port_from_the_jax_package():
    assert forbidden_modules(["blendjax_torch", "blendjax_torch.models", "jaxtyping"]) == []
    assert forbidden_modules(["blendjax.models.seqformer", "torch"]) == ["blendjax"]
    assert forbidden_modules(["jaxlib.xla_client", "flax", "jax"]) == ["flax", "jax", "jaxlib"]


def test_portbench_a_run_loads_neither_jax_nor_the_jax_package():
    tops = _tops(TINY_RUN)
    assert "blendjax_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "blendjax"}


def test_portbench_the_reference_loads_nothing_of_the_program():
    tops = _tops("import portbench.reference.seqformer, portbench.reference.pendulum, "
                 "portbench.reference.fp8, portbench.harness.weights, portbench.harness.work")
    assert not tops & {"jax", "jaxlib", "flax", "blendjax", "blendjax_torch"}
