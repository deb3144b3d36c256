"""Pluggable viewers for ``RemoteEnv.render(mode='human')``, the port of
``blendjax.btt.env_rendering``: a registry of backends and a matplotlib
one, which imports matplotlib only when it is constructed."""

from __future__ import annotations

#: name -> class; the first constructible entry wins when backend=None
RENDER_BACKENDS = {}


def register_backend(name, cls):
    RENDER_BACKENDS[name] = cls


def create_renderer(backend=None):
    """Instantiate a viewer; ``backend=None`` picks the first usable one."""
    if backend is not None:
        return RENDER_BACKENDS[backend]()
    errors = []
    for name, cls in RENDER_BACKENDS.items():
        try:
            return cls()
        except ImportError as e:  # try the next backend
            errors.append(f"{name}: {e}")
    raise ImportError("No usable render backend; install matplotlib. Tried: "
                      + "; ".join(errors))


class MatplotlibRenderer:
    """An interactive imshow window updated per frame."""

    def __init__(self):
        import matplotlib.pyplot as plt

        self._plt = plt
        plt.ion()
        self.fig, self.ax = plt.subplots()
        self.ax.set_axis_off()
        self.img = None

    def imshow(self, rgb):
        if self.img is None:
            self.img = self.ax.imshow(rgb)
        else:
            self.img.set_data(rgb)
        self.fig.canvas.draw_idle()
        self._plt.pause(0.001)

    def close(self):
        self._plt.close(self.fig)


register_backend("matplotlib", MatplotlibRenderer)
