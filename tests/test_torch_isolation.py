"""The port stands alone: ``blendjax_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, the producer side imports no torch, and
the two packages' wire encodings decode each other's frames."""

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
    code = (
        "import json, sys\n"
        "import blendjax_torch, blendjax_torch.btb as btb\n"
        "btb.parse_blendtorch_args, btb.DataPublisher, btb.constants\n"
        "import blendjax_torch.wire, blendjax_torch.btt.dataset, blendjax_torch.btt.launcher\n"
        "import blendjax_torch.btb.pendulum\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax'))))\n"
    )
    assert _run(code) == []


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
