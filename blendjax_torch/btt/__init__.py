"""blendjax_torch.btt — consumer-side package (training host, PyTorch).

The DataLoader role is played by :class:`blendjax_torch.btt.loader.BatchLoader`
plus the pinned-memory device feed in :mod:`blendjax_torch.btt.prefetch`;
the RL side by :class:`~blendjax_torch.btt.env.RemoteEnv` and the batched,
pipelined :class:`~blendjax_torch.btt.envpool.EnvPool`; the control plane
into running producers by :class:`~blendjax_torch.btt.duplex.DuplexChannel`.
Attribute access is lazy so importing the package drags in neither torch
nor zmq (only the device feed needs torch, only the sockets need zmq).
"""

__version__ = "0.1.0"

_LAZY = {
    "BlenderLauncher": ("blendjax_torch.btt.launcher", "BlenderLauncher"),
    "discover_blender": ("blendjax_torch.btt.finder", "discover_blender"),
    "LaunchInfo": ("blendjax_torch.btt.launch_info", "LaunchInfo"),
    "RemoteIterableDataset": ("blendjax_torch.btt.dataset", "RemoteIterableDataset"),
    "SingleFileDataset": ("blendjax_torch.btt.dataset", "SingleFileDataset"),
    "FileDataset": ("blendjax_torch.btt.dataset", "FileDataset"),
    "FileRecorder": ("blendjax_torch.btt.file", "FileRecorder"),
    "FileReader": ("blendjax_torch.btt.file", "FileReader"),
    "DuplexChannel": ("blendjax_torch.btt.duplex", "DuplexChannel"),
    "BatchLoader": ("blendjax_torch.btt.loader", "BatchLoader"),
    "collate": ("blendjax_torch.btt.collate", "collate"),
    "TransferGate": ("blendjax_torch.btt.prefetch", "TransferGate"),
    "device_prefetch": ("blendjax_torch.btt.prefetch", "device_prefetch"),
    "TorchStream": ("blendjax_torch.btt.prefetch", "TorchStream"),
    "get_primary_ip": ("blendjax_torch.btt.utils", "get_primary_ip"),
    "RemoteEnv": ("blendjax_torch.btt.env", "RemoteEnv"),
    "launch_env": ("blendjax_torch.btt.env", "launch_env"),
    "OpenAIRemoteEnv": ("blendjax_torch.btt.env", "OpenAIRemoteEnv"),
    "EnvPool": ("blendjax_torch.btt.envpool", "EnvPool"),
    "launch_env_pool": ("blendjax_torch.btt.envpool", "launch_env_pool"),
    "FaultPolicy": ("blendjax_torch.btt.faults", "FaultPolicy"),
    "CircuitOpenError": ("blendjax_torch.btt.faults", "CircuitOpenError"),
    "launch_vector_env": ("blendjax_torch.btt.vector_env", "launch_vector_env"),
    "RpcChannel": ("blendjax_torch.btt.transport", "RpcChannel"),
    "FleetSupervisor": ("blendjax_torch.btt.supervise", "FleetSupervisor"),
    "aggregate_health": ("blendjax_torch.btt.supervise", "aggregate_health"),
    "ChaosProxy": ("blendjax_torch.btt.chaos", "ChaosProxy"),
    "kill_instance": ("blendjax_torch.btt.chaos", "kill_instance"),
    "as_torch_iterable": ("blendjax_torch.btt.torch_compat", "as_torch_iterable"),
    "as_torch_map": ("blendjax_torch.btt.torch_compat", "as_torch_map"),
}

_LAZY_MODULES = (
    "launcher",
    "finder",
    "launch_info",
    "dataset",
    "file",
    "duplex",
    "loader",
    "collate",
    "prefetch",
    "utils",
    "constants",
    "env",
    "envpool",
    "faults",
    "vector_env",
    "shm_rpc",
    "rpc",
    "transport",
    "torch_compat",
    "env_rendering",
    "supervise",
    "chaos",
    "watchdog",
)


def __getattr__(name):
    import importlib

    if name in _LAZY:
        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value
        return value
    if name in _LAZY_MODULES:
        mod = importlib.import_module(f"blendjax_torch.btt.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'blendjax_torch.btt' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list(_LAZY) + list(_LAZY_MODULES)))
