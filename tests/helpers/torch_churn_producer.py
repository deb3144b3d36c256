"""Producer child for the port's ring stress harness
(``tests/test_torch_ring_stress.py``): the port's ``DataPublisher``
publishes ``{btid, gen, frameid, payload}`` messages until killed, as
``churn_producer.py`` does with the reference's.  ``gen`` is the process
generation: the harness SIGKILLs producers and respawns them under the same
address with gen + 1.

Run: python torch_churn_producer.py --addr shm://... --btid N --gen G [--rate-hz HZ]
"""

import argparse
import ctypes
import signal
import time

import numpy as np

from blendjax_torch.btb.publisher import DataPublisher


def main():
    # PR_SET_PDEATHSIG=SIGKILL: a hard-killed harness leaves no publish loop
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    ap = argparse.ArgumentParser()
    ap.add_argument("--addr", required=True)
    ap.add_argument("--btid", type=int, required=True)
    ap.add_argument("--gen", type=int, required=True)
    ap.add_argument("--payload", type=int, default=4096)
    ap.add_argument("--rate-hz", type=float, default=0.0)
    args = ap.parse_args()

    rng = np.random.default_rng(args.btid * 1000 + args.gen)
    # varied sizes exercise the ring's wrap marker and padding
    payloads = [rng.integers(0, 255, size=rng.integers(64, args.payload), dtype=np.uint8)
                for _ in range(8)]
    pub = DataPublisher(args.addr, btid=args.btid, raw_buffers=True)
    period = 1.0 / args.rate_hz if args.rate_hz > 0 else 0.0
    frameid = 0
    while True:  # killed by the harness
        pub.publish(gen=args.gen, frameid=frameid, payload=payloads[frameid % 8])
        frameid += 1
        if period:
            time.sleep(period)


if __name__ == "__main__":
    main()
