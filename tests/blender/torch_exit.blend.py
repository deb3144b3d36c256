"""Producer fixture for the port that publishes once and exits (the
watchdog tests' ``exit.blend.py`` on ``blendjax_torch.btb``)."""

import time

import zmq

from blendjax_torch.btb.arguments import parse_blendtorch_args
from blendjax_torch.btb.publisher import DataPublisher


def main():
    args, _ = parse_blendtorch_args()
    pub = DataPublisher(args.btsockets["DATA"], btid=args.btid)
    pub.sock.setsockopt(zmq.LINGER, 2000)  # let the message out before the exit
    pub.publish(btid=args.btid)
    time.sleep(0.2)  # let the consumer drain before the socket dies


main()
