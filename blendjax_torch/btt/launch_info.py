"""Launch metadata: ``LaunchInfo`` carries the socket addresses (grouped
by name), the spawn command lines and the process handles of a launch.
Its JSON round trip is the multi-machine handoff: launch a fleet on one
host with ``python -m blendjax_torch.btt.apps.launch``, ship the file, and
connect a ``RemoteIterableDataset`` to ``info.addresses['DATA']`` on
another."""

from __future__ import annotations

import json
from contextlib import nullcontext


class LaunchInfo:
    """Addresses, commands (argv lists, Popen-ready) and (optionally)
    process handles of a launch."""

    def __init__(self, addresses, commands, processes=None):
        self.addresses = dict(addresses)
        self.commands = list(commands)
        self.processes = processes

    def __repr__(self):
        return f"LaunchInfo(addresses={self.addresses!r})"

    @staticmethod
    def save_json(file, launch_info):
        """Write addresses and commands as JSON to a path or file-like object."""
        ctx = nullcontext(file) if hasattr(file, "write") else open(file, "w", encoding="utf-8")
        with ctx as fp:
            json.dump({"addresses": launch_info.addresses, "commands": launch_info.commands},
                      fp, indent=2)

    @staticmethod
    def load_json(file) -> "LaunchInfo":
        """Read a :class:`LaunchInfo` from a path or file-like object."""
        ctx = nullcontext(file) if hasattr(file, "read") else open(file, "r", encoding="utf-8")
        with ctx as fp:
            data = json.load(fp)
        return LaunchInfo(data["addresses"], data["commands"])
