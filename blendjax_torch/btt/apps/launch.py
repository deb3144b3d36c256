"""Headless multi-machine launch: ``python -m blendjax_torch.btt.apps.launch``.

Reads a JSON file whose dict holds :class:`~blendjax_torch.btt.launcher.
BlenderLauncher` keyword arguments, launches the fleet, writes its
connection info to ``--out-launch-info`` (default ``launch_info.json``),
and blocks until the instances exit.  A consumer on another host restores
the addresses with ``LaunchInfo.load_json`` and connects its dataset or
duplex sockets directly.

Example JSON::

    {
        "scene": "",
        "script": "cube.blend.py",
        "num_instances": 4,
        "named_sockets": ["DATA"],
        "background": true,
        "bind_addr": "primaryip",
        "seed": 10
    }
"""

from __future__ import annotations

import argparse
import json
import logging

from blendjax_torch.btt.launch_info import LaunchInfo
from blendjax_torch.btt.launcher import BlenderLauncher


def main(inargs=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        "blendjax_torch.btt.apps.launch", description=__doc__,
        formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--out-launch-info", default="launch_info.json",
                        help="Path to write connection info to.")
    parser.add_argument("jsonargs", help="Path to JSON dict of BlenderLauncher kwargs.")
    args = parser.parse_args(inargs)

    with open(args.jsonargs, "r", encoding="utf-8") as fp:
        launch_args = json.load(fp)

    with BlenderLauncher(**launch_args) as bl:
        LaunchInfo.save_json(args.out_launch_info, bl.launch_info)
        bl.wait()


if __name__ == "__main__":
    main()
