"""Producer fixture on the port's channel: echoes each received duplex
message back with its btmid, then sends an 'end' marker after N echoes
(the port's copy of ``tests/blender/duplex.blend.py``)."""

import argparse

from blendjax_torch.btb.arguments import parse_blendtorch_args
from blendjax_torch.btb.duplex import DuplexChannel


def main():
    btargs, remainder = parse_blendtorch_args()
    parser = argparse.ArgumentParser()
    parser.add_argument("--necho", type=int, default=2)
    args = parser.parse_args(remainder)

    duplex = DuplexChannel(btargs.btsockets["CTRL"], btid=btargs.btid)
    for _ in range(args.necho):
        msg = duplex.recv(timeoutms=20000)
        if msg is None:
            return
        duplex.send(echo=msg["payload"], got_mid=msg["btmid"])
    duplex.send(marker="end")


main()
