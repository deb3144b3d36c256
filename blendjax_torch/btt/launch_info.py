"""Launch metadata: ``LaunchInfo`` carries the socket addresses (grouped
by name), the spawn command lines and the process handles of a launch.
The JSON handoff of ``blendjax.btt.launch_info`` is not ported."""

from __future__ import annotations


class LaunchInfo:
    """Addresses, commands (argv lists, Popen-ready) and (optionally)
    process handles of a launch."""

    def __init__(self, addresses, commands, processes=None):
        self.addresses = dict(addresses)
        self.commands = list(commands)
        self.processes = processes

    def __repr__(self):
        return f"LaunchInfo(addresses={self.addresses!r})"
