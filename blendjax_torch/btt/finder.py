"""Locate a usable Blender executable.

Discovery order:
1. ``$BLENDJAX_BLENDER`` — explicit executable path or wrapper script (an
   ``xvfb-run``/EGL wrapper on headless hosts, or a fake Blender in tests).
2. ``blender`` on PATH (optionally extended by ``additional_blender_paths``).

The candidate is validated by parsing ``blender --version`` and checking
that its embedded Python can ``import zmq``.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

logger = logging.getLogger("blendjax_torch")

_PROBE_SCRIPT = "import zmq\n"
_VERSION_RE = re.compile(r"Blender\s+(\d+)\.(\d+)", re.IGNORECASE)

#: Discovery result cache, keyed by (override, extra paths): an executable
#: that cannot have changed is not re-validated on every launch.
_CACHE: dict = {}


def _probe(bpath: Path, env) -> bool:
    """True if Blender's embedded Python can import zmq."""
    fd, name = tempfile.mkstemp(suffix=".py", text=True)
    try:
        with os.fdopen(fd, "w") as fp:
            fp.write(_PROBE_SCRIPT)
        result = subprocess.run(
            [
                str(bpath),
                "--background",
                "--python-use-system-env",
                "--python-exit-code",
                "255",
                "--python",
                name,
            ],
            capture_output=True,
            env=env,
            timeout=120,
        )
        return result.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        os.unlink(name)


def discover_blender(additional_blender_paths=None):
    """Return ``{'path': Path, 'major': int, 'minor': int}`` or ``None``."""
    key = (os.environ.get("BLENDJAX_BLENDER"), str(additional_blender_paths))
    if key in _CACHE:
        return _CACHE[key]
    info = _discover_uncached(additional_blender_paths)
    if info is not None:
        _CACHE[key] = info
    return info


def _discover_uncached(additional_blender_paths=None):
    env = os.environ.copy()
    if additional_blender_paths is not None:
        env["PATH"] = str(additional_blender_paths) + os.pathsep + env.get("PATH", "")

    override = env.get("BLENDJAX_BLENDER")
    if override:
        bpath = Path(override)
        if not bpath.exists():
            logger.warning("BLENDJAX_BLENDER=%s does not exist.", override)
            return None
    else:
        found = shutil.which("blender", path=env.get("PATH"))
        if found is None:
            logger.warning("Could not find Blender on PATH.")
            return None
        bpath = Path(found).resolve()

    try:
        result = subprocess.run(
            [str(bpath), "--version"], capture_output=True, env=env, timeout=60
        )
    except (OSError, subprocess.TimeoutExpired):
        logger.warning("Failed to execute %s --version", bpath)
        return None

    match = _VERSION_RE.search(result.stdout.decode(errors="replace"))
    if result.returncode != 0 or match is None:
        logger.warning("Failed to parse Blender version from %s.", bpath)
        return None

    if not _probe(bpath, env):
        logger.warning(
            "Blender at %s cannot import zmq in its embedded Python; "
            "install the producer requirements into Blender.",
            bpath,
        )
        return None

    return {"path": bpath, "major": int(match[1]), "minor": int(match[2])}
