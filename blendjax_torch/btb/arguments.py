"""Launcher -> Blender-script argument protocol.

The launcher passes framework args after Blender's ``--`` separator:
``-btid <int> -btseed <int> -btsockets NAME=ADDR [NAME=ADDR ...]`` plus any
user-supplied per-instance args.  This module parses that protocol inside
the Blender process; user scripts argparse the remainder.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field


@dataclass
class BlendJaxArgs:
    """Parsed framework arguments for one producer instance."""

    btid: int = 0
    btseed: int = 0
    btsockets: dict = field(default_factory=dict)


def _parse_socket_list(pairs):
    sockets = {}
    for item in pairs:
        name, sep, addr = item.partition("=")
        if not sep or not name or not addr:
            raise ValueError(
                f"invalid -btsockets entry {item!r}; expected NAME=ADDRESS"
            )
        sockets[name] = addr
    return sockets


def parse_blendtorch_args(argv=None):
    """Parse framework args after Blender's ``--`` separator.

    Returns ``(BlendJaxArgs, remainder)`` where ``remainder`` holds any
    unrecognized args for the user script's own argparse.  ``argv``
    defaults to ``sys.argv``; only tokens after the first ``--`` are
    considered, mirroring Blender's convention of ignoring script args.
    """
    argv = list(sys.argv) if argv is None else list(argv)
    if "--" in argv:
        argv = argv[argv.index("--") + 1:]

    parser = argparse.ArgumentParser(prog="blendjax_torch", add_help=False)
    parser.add_argument("-btid", type=int, default=0, help="producer instance id")
    parser.add_argument("-btseed", type=int, default=0, help="per-instance RNG seed")
    parser.add_argument(
        "-btsockets",
        nargs="*",
        default=[],
        metavar="NAME=ADDR",
        help="named socket addresses",
    )
    known, remainder = parser.parse_known_args(argv)

    args = BlendJaxArgs(
        btid=known.btid,
        btseed=known.btseed,
        btsockets=_parse_socket_list(known.btsockets),
    )
    return args, remainder
