"""blendjax_torch.serve — the policy-serving tier on the card, the port of
``blendjax.serve``::

    from blendjax_torch.serve import (
        PolicyServer, ServeClient, ServeRPCError, SeqFormerModel,
        PolicyModel, LinearModel, start_server_thread, ServerFleet,
        ServeGateway, start_gateway_thread, start_sharded_gateway_thread,
    )

One :class:`~blendjax_torch.serve.server.PolicyServer` owns a model (the
SeqFormer world model over a KV-cache slot pool, the MLP policy, or the
numpy linear stand-in) and serves ``step()``/``reset()``/``close()`` to
many concurrent episode clients with continuous batching; retries are
exactly-once via the ``wire.BTMID_KEY`` reply cache.  The wire is the JAX
package's: each package's client talks to the other's server and gateway.
:class:`~blendjax_torch.serve.server.ServerFleet` runs N replica processes
(on the card unless ``device="cpu"``), and
:class:`~blendjax_torch.serve.gateway.ServeGateway` (or the sharded
gateway, :func:`start_sharded_gateway_thread`) routes clients over them.
Attribute access is lazy, so a client-only consumer or a gateway never
imports the model stack.
"""

_LAZY = {
    "PolicyServer": "blendjax_torch.serve.server",
    "LinearModel": "blendjax_torch.serve.server",
    "PolicyModel": "blendjax_torch.serve.server",
    "SeqFormerModel": "blendjax_torch.serve.server",
    "ServerProcess": "blendjax_torch.serve.server",
    "ServerFleet": "blendjax_torch.serve.server",
    "start_server_thread": "blendjax_torch.serve.server",
    "default_buckets": "blendjax_torch.serve.server",
    "ServeClient": "blendjax_torch.serve.client",
    "ServeRPCError": "blendjax_torch.serve.client",
    "ServeGateway": "blendjax_torch.serve.gateway",
    "start_gateway_thread": "blendjax_torch.serve.gateway",
    "start_sharded_gateway_thread": "blendjax_torch.serve.gateway",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    import importlib

    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'blendjax_torch.serve' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list(_LAZY)))
