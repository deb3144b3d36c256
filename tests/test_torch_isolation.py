"""The port stands alone: ``blendjax_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, the producer side (the publisher and the
native ring included) imports no torch, the port's ring loads its own
library and never the JAX package's, and the two packages' wire encodings
decode each other's frames."""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from blendjax import wire as jwire
from blendjax_torch import wire as twire

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "blendjax_torch"


def _modules():
    """Every importable module of the package (``*.blend.py`` producer
    scripts are run, not imported)."""
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        if "." in rel.name:
            continue
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return names


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_package_and_smoke_import_without_jax():
    mods = _modules()
    assert "blendjax_torch.ops.image" in mods and "blendjax_torch.btt.prefetch" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'blendjax' or m.startswith('blendjax.'))\n"
        "print(json.dumps(bad))\n"
    )
    assert _run(code) == []


def test_sources_name_neither_jax_nor_blendjax():
    """Catches imports inside functions that an import pass never runs."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|blendjax)(\.|\s|$)")
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [f"{f.relative_to(REPO)}:{i}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert hits == []


def test_producer_side_imports_without_torch():
    """The producer side (the shm ring writer too), a serving client (with
    the snapshot format and the ShmRPC transport), the checkpoint files, the
    watchdog, the replay buffer, the replay shard service and its client,
    the weight bus, the telemetry hub and the fleet supervisor import
    neither torch nor JAX."""
    code = (
        "import json, sys\n"
        "import blendjax_torch, blendjax_torch.btb as btb\n"
        "btb.parse_blendtorch_args, btb.DataPublisher, btb.constants\n"
        "import blendjax_torch.wire, blendjax_torch.btt.dataset, blendjax_torch.btt.launcher\n"
        "import blendjax_torch.btb.pendulum\n"
        "import blendjax_torch.btb.env, blendjax_torch.btb.animation, blendjax_torch.btb.signal\n"
        "import blendjax_torch.btb.cartpole\n"
        "btb.BaseEnv, btb.RemoteControlledAgent, btb.AnimationController\n"
        "import blendjax_torch.btt.env, blendjax_torch.btt.envpool, blendjax_torch.btt.faults\n"
        "import blendjax_torch._duplex, blendjax_torch.btb.duplex, blendjax_torch.btt.duplex\n"
        "import blendjax_torch.btb.camera, blendjax_torch.btb.camera_math\n"
        "import blendjax_torch.btb.utils, blendjax_torch.btb.offscreen\n"
        "btb.DuplexChannel, btb.Camera, btb.OffScreenRenderer\n"
        "import blendjax_torch.serve.client, blendjax_torch.weights.snapshot\n"
        "import blendjax_torch.utils.checkpoint, blendjax_torch.btt.watchdog\n"
        "import blendjax_torch.replay.ring, blendjax_torch.replay.buffer, blendjax_torch.ha\n"
        "from blendjax_torch.serve import ServeClient, ServeRPCError\n"
        "import blendjax_torch.native, blendjax_torch.native.ring as ring\n"
        "import blendjax_torch.btt.shm_rpc, blendjax_torch.btt.transport\n"
        "import blendjax_torch.btt.rpc, blendjax_torch.btt.env_rendering\n"
        "import blendjax_torch.btt.apps.launch\n"
        "import blendjax_torch.obs.hub, blendjax_torch.btt.chaos, blendjax_torch.btt.supervise\n"
        "import blendjax_torch.replay.service, blendjax_torch.replay.shard_client\n"
        "import blendjax_torch.weights.bus\n"
        "import blendjax_torch.scenario, blendjax_torch.scenario.catalog\n"
        "import blendjax_torch.scenario.curriculum, blendjax_torch.scenario.randomize\n"
        "from blendjax_torch.scenario import ScenarioCatalog, DomainRandomizer\n"
        "from blendjax_torch.scenario import CurriculumScheduler, apportion\n"
        "from blendjax_torch.replay import ShardedReplay, ShardFleet\n"
        "from blendjax_torch.weights import WeightPublisher, WeightSubscriber\n"
        "from blendjax_torch.obs import TelemetryHub\n"
        "assert ring.native_available(), ring.load_error()\n"
        "import os\n"
        "addr = 'shm://bjx-test-t-iso-%d' % os.getpid()\n"
        "pub = btb.DataPublisher(addr, btid=0)\n"
        "assert pub.publish(x=1)\n"
        "pub.close()\n"
        "ring.unlink_address(addr)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax'))))\n"
    )
    assert _run(code) == []


def test_measurement_plane_imports_without_torch(tmp_path):
    """``blendjax_torch.utils`` (its lazy names included), ``utils.timing``,
    ``utils.fence`` and ``obs.spans`` import without torch: a traced timer
    and a span recorder export their chrome traces, and the fences import
    torch only when one is called."""
    code = (
        "import json, sys\n"
        "import blendjax_torch.utils as u, blendjax_torch.utils.timing\n"
        "import blendjax_torch.utils.fence, blendjax_torch.obs.spans\n"
        "from blendjax_torch.obs import export_chrome_trace, load_chrome_trace, SpanRecorder\n"
        "u.value_fence, u.fence_chain, u.fences_valid, u.save_pytree\n"
        "t = u.StageTimer(trace=True)\n"
        "with t.stage('recv'): pass\n"
        f"assert t.export_chrome_trace({str(tmp_path / 't.json')!r}) == 1\n"
        "r = SpanRecorder()\n"
        "with r.span('x'): pass\n"
        f"assert export_chrome_trace({str(tmp_path / 's.json')!r}, r) == 1\n"
        f"assert len(load_chrome_trace({str(tmp_path / 's.json')!r})) == 1\n"
        "assert u.value_fence([1.0, None]) == 0.0  # no array leaf: no torch\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax'))))\n"
    )
    assert _run(code) == []


def test_fences_run_without_jax():
    """The fences run on torch alone: neither JAX nor the JAX package is
    imported by a fence over a tree, a chain, or the self-check."""
    code = (
        "import json, sys, numpy as np, torch\n"
        "from blendjax_torch.utils.fence import value_fence, fence_chain, fences_valid\n"
        "assert value_fence({'a': torch.ones(2), 'b': [np.full(3, 2.0)]}) == 3.0\n"
        "c = fence_chain(device='cpu'); c.fold(torch.ones(4)); assert c.sync() == 1.0\n"
        "fences_valid(1e18, device='cpu')\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "                        or m == 'blendjax' or m.startswith('blendjax.'))))\n"
    )
    assert _run(code) == []


@pytest.mark.parametrize("module", ["blendjax_torch.replay.service",
                                    "blendjax_torch.weights.bus",
                                    "blendjax_torch.serve.gateway",
                                    "blendjax_torch.serve.gateway_worker"])
def test_spawned_services_help_without_torch(module):
    """The processes the port spawns for the replay service and the weight
    bus start without torch: ``--help`` runs the whole module import and
    the argument parser, and leaves torch (and JAX) out of
    ``sys.modules``."""
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = ['{module}', '--help']\n"
        "try:\n"
        f"    runpy.run_module('{module}', run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    assert exc.code == 0, exc.code\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax'))))\n"
    )
    assert _run(code) == []


def test_gateway_worker_and_autoscaler_import_without_torch():
    """The gateway, its worker, the canary controller and the autoscaler
    are routers and controllers: they import neither torch nor JAX nor any
    module of the JAX package, and a gateway in a thread routes a linear
    replica without them."""
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "import blendjax_torch.serve.gateway, blendjax_torch.serve.gateway_worker\n"
        "import blendjax_torch.autoscale, blendjax_torch.weights.controller\n"
        "from blendjax_torch.autoscale import AutoscaleController, reshard_replay\n"
        "from blendjax_torch.serve import (ServeClient, LinearModel, start_server_thread,\n"
        "                                  start_gateway_thread)\n"
        "h = start_server_thread(LinearModel(obs_dim=4, slots=2))\n"
        "g = start_gateway_thread([h.address])\n"
        "c = ServeClient(g.address, timeoutms=20000)\n"
        "c.reset()\n"
        "assert c.step(np.zeros(4, np.float32))['replica'] == 'r0'\n"
        "c.close(); g.close(); h.close()\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] in ('torch', 'jax', 'blendjax'))))\n"
    )
    assert _run(code) == []


def test_scenario_plane_imports_neither_torch_nor_any_jax_module():
    """``blendjax_torch.scenario`` stays import-light, as the reference's:
    numpy, and zmq only once a channel is dialled.  A catalog, a curriculum
    and a randomizer work without torch, JAX or the JAX package (and
    without zmq until the first push)."""
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from blendjax_torch.scenario import CurriculumScheduler, DomainRandomizer\n"
        "from blendjax_torch.scenario import ScenarioCatalog, ScenarioSpec, apportion\n"
        "cat = ScenarioCatalog([ScenarioSpec('a'), ScenarioSpec('b', physics_rate_us=5)])\n"
        "cat = ScenarioCatalog.from_json(cat.to_json())\n"
        "cur = CurriculumScheduler(cat)\n"
        "cur.pin({'b': 1.0}); cur.update()\n"
        "assert cur.assign(2) == ['b', 'b'] == apportion(cur.mix(), 2)\n"
        "rnd = DomainRandomizer(cat, [['tcp://127.0.0.1:1']])\n"
        "assert cat.sample('a', np.random.default_rng(0))['scenario'] == 'a'\n"
        "mods = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('torch', 'jax', 'blendjax', 'zmq'))\n"
        "rnd.close()\n"
        "print(json.dumps(mods))\n"
    )
    assert _run(code) == []


def test_native_ring_loads_only_its_own_library():
    """The port's ring maps ``libblendjax_torch_ring.so`` from ``build/``,
    never the JAX package's ``libblendjax_ring.so``."""
    code = (
        "import json\n"
        "from blendjax_torch.native import ring\n"
        "assert ring.native_available(), ring.load_error()\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(json.dumps([ring.LIBRARY in maps, 'libblendjax_ring.so' in maps]))\n"
    )
    assert _run(code) == [True, False]


def _message():
    rng = np.random.default_rng(0)
    return {"btid": 3, "frameid": 11,
            "image": rng.integers(0, 256, (4, 5, 3), dtype=np.uint8),
            "xy": rng.random((8, 2)).astype(np.float32),
            "nested": {"a": [np.arange(3), "s"], "t": (np.float32(1.5),)},
            "zero_d": np.array(2.0)}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("raw_buffers", [False, True])
@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
def test_wire_frames_decode_across_packages(raw_buffers, direction):
    enc, dec = (twire, jwire) if direction == "torch->jax" else (jwire, twire)
    msg = _message()
    frames = enc.encode(msg, raw_buffers=raw_buffers)
    assert [bytes(f) for f in frames] == [
        bytes(f) for f in dec.encode(msg, raw_buffers=raw_buffers)]
    _assert_same(dec.decode([bytes(f) for f in frames]), msg)
