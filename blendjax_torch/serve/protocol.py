"""The serving tier's wire constants and socket drain, shared by the policy
server and the gateway.

Torch-free on purpose: the gateway and its worker processes are routers
and must not pay the torch import at every spawn.
:mod:`blendjax_torch.serve.server` re-exports these names.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("blendjax_torch")

#: Commands whose replies enter the exactly-once reply cache.
MUTATING_CMDS = ("step", "reset", "close")

#: Default bound on the reply cache (each client keeps one RPC in flight).
REPLY_CACHE_DEPTH = 1024


def drain_socket(recv, handle, counters, who, what):
    """Drain every message on a socket: ``recv()`` (NOBLOCK) until
    ``zmq.Again``, dispatching each to ``handle``.  A closed socket
    propagates; an undecodable frame, or a message whose handling raises,
    is dropped and counted — it never stops the serving thread."""
    import zmq

    while True:
        try:
            out = recv()
        except zmq.Again:
            return
        except zmq.ZMQError:
            raise
        except Exception as exc:  # noqa: BLE001 - the tier survives
            counters.incr("serve_errors")
            logger.warning("%s: undecodable %s dropped (%s: %s)",
                           who, what, type(exc).__name__, exc)
            continue
        try:
            handle(out)
        except zmq.ZMQError:
            raise
        except Exception:  # noqa: BLE001 - the tier survives
            counters.incr("serve_errors")
            logger.exception("%s: handling a %s failed (dropped)", who, what)
