"""Producer-side duplex channel: binds the PAIR socket inside Blender, and
the consumer connects (a copy of ``blendjax.btb.duplex``)."""

from __future__ import annotations

from blendjax_torch._duplex import DuplexChannelBase
from blendjax_torch.btb.constants import DEFAULT_TIMEOUTMS


class DuplexChannel(DuplexChannelBase):
    DEFAULT_TIMEOUTMS = DEFAULT_TIMEOUTMS

    def __init__(self, address, btid=None, lingerms=0, timeoutms=None, raw_buffers=False):
        super().__init__(address, btid=btid, bind=True, lingerms=lingerms,
                         timeoutms=timeoutms, raw_buffers=raw_buffers)
