"""The port's ``torch.utils.data`` adapters (``blendjax_torch.btt.
torch_compat``) against the JAX package's (``blendjax.btt.torch_compat``).

- A ``DataLoader`` drives ``as_torch_iterable(RemoteIterableDataset)``:
  each worker streams ``max_items // num_workers`` items, as the
  reference's adapter over the reference's dataset does, checked per worker
  (with ``get_worker_info`` stood in) and over real worker processes.
- ``as_torch_map`` over a recorded ``FileDataset`` gives a ``DataLoader``
  the same batches as the reference's adapter over its own reader of the
  same files.

Every comparison is exact.
"""

import types

import numpy as np
import pytest
import torch.utils.data as tud

from blendjax.btt import torch_compat as jcompat
from blendjax.btt.dataset import FileDataset as JFileDataset
from blendjax.btt.dataset import RemoteIterableDataset as JRemoteIterableDataset
from blendjax_torch.btt import torch_compat
from blendjax_torch.btt.dataset import FileDataset, RemoteIterableDataset
from helpers.producers import ProducerFleet


@pytest.mark.parametrize("max_items,num_workers", [(10, 1), (10, 3), (16, 4), (7, 2)])
def test_per_worker_split_matches_reference(monkeypatch, max_items, num_workers):
    counts = {}
    with ProducerFleet(num_producers=2, raw_buffers=True) as fleet:
        for name, adapt, cls in (("port", torch_compat.as_torch_iterable,
                                  RemoteIterableDataset),
                                 ("ref", jcompat.as_torch_iterable, JRemoteIterableDataset)):
            per = []
            for wid in range(num_workers):
                info = types.SimpleNamespace(id=wid, num_workers=num_workers)
                monkeypatch.setattr(tud, "get_worker_info", lambda info=info: info)
                ds = adapt(cls(fleet.addresses, max_items=max_items, timeoutms=20000))
                assert isinstance(ds, tud.IterableDataset)
                per.append(sum(1 for _ in ds))
            counts[name] = per
    assert counts["port"] == counts["ref"] == [max_items // num_workers] * num_workers


#: the loader run in a fresh interpreter: its forked workers then start from
#: a parent with no threads (a test process has JAX's and ZMQ's)
_LOADER_SCRIPT = """
import json, sys
import torch.utils.data as tud
from blendjax_torch import datagen
from blendjax_torch.btt.dataset import RemoteIterableDataset
from blendjax_torch.btt.launcher import BlenderLauncher
from blendjax_torch.btt.torch_compat import as_torch_iterable

num_workers, port = int(sys.argv[1]), int(sys.argv[2])
with BlenderLauncher(scene="", script=str(datagen.FRAMES_SCRIPT), num_instances=2,
                     named_sockets=["DATA"], start_port=port, seed=0, background=True,
                     instance_args=[["--height", "16", "--width", "16"]] * 2) as bl:
    ds = RemoteIterableDataset(bl.launch_info.addresses["DATA"], max_items=12,
                               timeoutms=20000)
    loader = tud.DataLoader(as_torch_iterable(ds), batch_size=None, num_workers=num_workers,
                            multiprocessing_context="fork" if num_workers else None)
    items = list(loader)
print(json.dumps({"n": len(items), "shapes": sorted({tuple(it["image"].shape) for it in items}),
                  "types": sorted({type(it["image"]).__name__ for it in items})}))
"""


@pytest.mark.parametrize("num_workers", [0, 2])
def test_dataloader_drives_the_stream(num_workers):
    """Two fake-Blender producers streamed through a ``DataLoader`` over
    the adapter: every item arrives, collated by the loader to tensors."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from helpers import FAKE_BLENDER
    from test_torch_env import _free_block

    repo = Path(__file__).resolve().parent.parent
    env = {**os.environ, "BLENDJAX_BLENDER": FAKE_BLENDER}
    out = subprocess.run([sys.executable, "-c", _LOADER_SCRIPT, str(num_workers),
                          str(_free_block(2))], cwd=repo, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"n": 12, "shapes": [[16, 16, 3]], "types": ["Tensor"]}


def test_map_adapter_matches_reference(tmp_path):
    prefix = str(tmp_path / "rec")
    with ProducerFleet(num_producers=1, raw_buffers=True) as fleet:
        list(RemoteIterableDataset(fleet.addresses, max_items=8, timeoutms=20000,
                                   record_path_prefix=prefix).stream())
    port = torch_compat.as_torch_map(FileDataset(prefix))
    ref = jcompat.as_torch_map(JFileDataset(prefix))
    assert isinstance(port, tud.Dataset) and len(port) == len(ref) == 8
    got = list(tud.DataLoader(port, batch_size=4))
    want = list(tud.DataLoader(ref, batch_size=4))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


def test_recording_replay_roundtrip(tmp_path):
    """``tests/test_dataset.py::test_recording_replay_roundtrip`` on the
    port: ``enable_recording`` before iteration, the replay equal to the
    live items; ``stream_length`` sets ``max_items`` as the reference's."""
    prefix = str(tmp_path / "rec")
    with ProducerFleet(num_producers=1) as fleet:
        ds = RemoteIterableDataset(fleet.addresses, max_items=100)
        ds.stream_length(6)
        ref = JRemoteIterableDataset(fleet.addresses, max_items=100)
        ref.stream_length(6)
        assert ds.max_items == ref.max_items == 6
        ds.enable_recording(prefix)
        assert ds.record_path_prefix == prefix and not ds.supports_batched_stream()
        live = list(ds.stream())
    replay = FileDataset(prefix)
    assert len(replay) == 6
    for i in range(6):
        np.testing.assert_array_equal(replay[i]["image"], live[i]["image"])
        assert replay[i]["frameid"] == live[i]["frameid"]
