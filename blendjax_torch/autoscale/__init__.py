"""Live autoscaling, the port of ``blendjax.autoscale``: resize the serve
fleet and the replay shard set while the system serves traffic, every
transition verified and reversible.

- :class:`AutoscaleController` — the serve-tier control loop: scraped queue
  depth and p99 drive ``grow``/``drain``/``retire`` decisions with
  hysteresis bands, per-direction cooldowns and a healthy window that rolls
  back a resize that regressed.
- :func:`reshard_replay` — the replay-tier resize: grow the shard fleet by
  one process and hand it a slot range crash-exactly, the draw stream
  staying bit-identical.

Imports no torch: the controller drives a gateway and a fleet, and
computes nothing on the card.
"""

from blendjax_torch.autoscale.controller import AutoscaleController
from blendjax_torch.autoscale.reshard import reshard_replay

__all__ = ["AutoscaleController", "reshard_replay"]
