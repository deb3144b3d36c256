"""Consumer-side network utilities."""

from __future__ import annotations

import socket


def get_primary_ip() -> str:
    """IP of the default-route interface; falls back to localhost.

    Uses the UDP-connect trick: no packet is sent, the OS just resolves the
    route.  Used by the launcher's ``bind_addr='primaryip'`` mode so
    consumers on other hosts can connect.
    """
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()
