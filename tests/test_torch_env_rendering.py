"""``RemoteEnv.render(mode="human")`` and the viewer registry
(``blendjax_torch.btt.env_rendering``) with a registered stub backend, held
to the reference's registry semantics (``blendjax.btt.env_rendering``): a
named backend is built, ``backend=None`` takes the first constructible one
in registration order, and none usable raises ImportError naming each."""

import numpy as np
import pytest

from blendjax.btt import env_rendering as jrend
from blendjax_torch.btt import env_rendering as rend
from blendjax_torch.btt.env import RemoteEnv


class Stub:
    instances = []

    def __init__(self):
        self.frames, self.closed = [], False
        Stub.instances.append(self)

    def imshow(self, rgb):
        self.frames.append(np.array(rgb))

    def close(self):
        self.closed = True


class Broken:
    def __init__(self):
        raise ImportError("no display library")


@pytest.fixture
def registry(monkeypatch):
    for mod in (rend, jrend):
        monkeypatch.setattr(mod, "RENDER_BACKENDS", {})
        mod.register_backend("broken", Broken)
        mod.register_backend("stub", Stub)
    Stub.instances = []
    yield


def test_human_render_shows_frames_in_one_viewer(registry):
    env = RemoteEnv("tcp://127.0.0.1:9", timeoutms=100)  # never sent to
    try:
        assert env.render() is None  # no frame yet: nothing to show
        frames = [np.full((4, 5, 3), i, np.uint8) for i in range(3)]
        for f in frames:
            env.rgb_array = f
            assert env.render(mode="human", backend="stub") is None
            assert env.render(mode="rgb_array") is f
        (viewer,) = Stub.instances
        assert env.viewer is viewer
        assert [v.tolist() for v in viewer.frames] == [f.tolist() for f in frames]
    finally:
        env.close()
    assert viewer.closed and env.viewer is None


def test_registry_matches_reference(registry):
    for mod in (rend, jrend):
        assert isinstance(mod.create_renderer(), Stub)  # "broken" is skipped
        assert isinstance(mod.create_renderer("stub"), Stub)
        with pytest.raises(ImportError, match="no display library"):
            mod.create_renderer("broken")
    for mod in (rend, jrend):
        mod.RENDER_BACKENDS.pop("stub")
        with pytest.raises(ImportError, match="broken: no display library"):
            mod.create_renderer()


def test_matplotlib_backend_registered_lazily():
    """Registered at import, imported only when a viewer is built (the card
    machine has no matplotlib)."""
    import subprocess
    import sys
    from pathlib import Path

    assert rend.RENDER_BACKENDS["matplotlib"] is rend.MatplotlibRenderer
    code = ("import sys, blendjax_torch.btt.env_rendering, blendjax_torch.btt.env\n"
            "print(any(m.split('.')[0] == 'matplotlib' for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parent.parent, timeout=60)
    assert out.stdout.strip() == "False", out.stderr
