"""Native (C++) components of the port: the shared-memory ring, built at
first use with ``g++`` (:mod:`blendjax_torch.native.ring`).  Everything
here is optional: the ZMQ paths work without it."""

from blendjax_torch.native.ring import (  # noqa: F401
    DoorBell,
    ShmRingReader,
    ShmRingWriter,
    copy_into,
    fast_stack,
    gather_into,
    is_shm_address,
    native_available,
    shm_name_from_address,
    unlink_address,
)
