"""Spawn and tear down Blender producer fleets.

``BlenderLauncher`` is a context manager that starts ``num_instances``
Blender processes, each running a user script with the framework arg
protocol (``-btid/-btseed/-btsockets`` after Blender's ``--`` separator)
and one pre-allocated address per named socket per instance.  Each child
runs in its own process group; shutdown escalates terminate -> kill on the
whole group with a timeout, and launch failures raise ``RuntimeError``;
``respawn(idx)`` relaunches one instance with its original command line.
``proto`` picks the transport of the allocated addresses: ``tcp``,
``ipc`` (a socket file under :func:`tempfile.gettempdir`) or ``shm``
(same-host shared-memory rings, :mod:`blendjax_torch.native.ring`, named
under a per-launch nonce and swept at exit and before a respawn).
"""

from __future__ import annotations

import logging
import os
import signal as _signal
import subprocess
import tempfile

import numpy as np

from blendjax_torch.btt.finder import discover_blender
from blendjax_torch.btt.launch_info import LaunchInfo
from blendjax_torch.btt.utils import get_primary_ip

logger = logging.getLogger("blendjax_torch")


def popen_group_kwargs():
    """Popen kwargs isolating the child in its own process group, so fleet
    teardown can signal whole process trees without touching the caller's
    group."""
    if os.name == "posix":
        return {"preexec_fn": os.setsid}
    if os.name == "nt":
        return {"creationflags": subprocess.CREATE_NEW_PROCESS_GROUP}
    return {}


def child_env():
    """Environment for producer subprocesses.

    ``--python-use-system-env`` tells Blender to honor PYTHONPATH; prepend
    the directory that holds ``blendjax_torch`` so producer scripts import
    the port's ``btb`` even when the launching process found it via cwd
    alone.
    """
    env = os.environ.copy()
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH", "")) if p
    )
    return env


class BlenderLauncher:
    """Context manager launching and tearing down Blender instances.

    Params
    ------
    scene: str
        ``.blend`` scene file each instance opens ('' or None for none).
    script: str
        Python script Blender runs (the producer-side ``*.blend.py``).
    num_instances: int
        Number of Blender processes to spawn.
    named_sockets: list[str]
        Socket names to pre-allocate addresses for; passed to instances as
        ``-btsockets NAME=ADDR ...`` and exposed via ``launch_info``.
    start_port: int
        First port of the allocated range (one port per socket per instance).
    bind_addr: str
        Bind address for producer sockets; ``'primaryip'`` resolves the
        default-route interface so other hosts can connect.
    instance_args: list[list[str]] | None
        Extra per-instance CLI args appended after the framework args.
    proto: str
        Transport: ``'tcp'`` (default), ``'ipc'``, or ``'shm'`` (native
        same-host shared-memory rings).
    blend_path: str | None
        Extra PATH entries searched for the Blender executable.
    seed: int | None
        Base seed; instance ``i`` receives ``seed + i``.
    background: bool
        Pass ``--background`` (headless).
    shutdown_grace: float
        Seconds to wait after terminate before killing the process group.
    """

    def __init__(
        self,
        scene,
        script,
        num_instances=1,
        named_sockets=None,
        start_port=11000,
        bind_addr="127.0.0.1",
        instance_args=None,
        proto="tcp",
        blend_path=None,
        seed=None,
        background=False,
        shutdown_grace=5.0,
    ):
        if num_instances <= 0:
            raise ValueError("num_instances must be positive")
        if proto not in ("tcp", "ipc", "shm"):
            raise ValueError(f"proto must be 'tcp', 'ipc' or 'shm', got {proto!r}")
        self.scene = scene
        self.script = script
        self.num_instances = num_instances
        self.named_sockets = list(named_sockets or [])
        self.start_port = start_port
        self.bind_addr = bind_addr
        self.proto = proto
        self.blend_path = blend_path
        self.seed = seed
        self.background = background
        self.shutdown_grace = shutdown_grace
        self.instance_args = (
            [list(a) for a in instance_args]
            if instance_args is not None
            else [[] for _ in range(num_instances)]
        )
        if len(self.instance_args) != num_instances:
            raise ValueError(
                f"instance_args has {len(self.instance_args)} entries "
                f"for {num_instances} instances"
            )
        # 8 hex chars of urandom: unique per launch, shared by respawns.
        # Every shm object of this launch sits under one glob-able prefix,
        # so teardown is one sweep, and a ring a killed earlier run left
        # behind is never mistaken for this launch's
        self._nonce = os.urandom(4).hex()
        self._shm_base = f"blendjax-{self._nonce}"

        self.blender_info = discover_blender(self.blend_path)
        if self.blender_info is None:
            raise RuntimeError(
                "Blender not found or misconfigured (set $BLENDJAX_BLENDER "
                "or install producer requirements into Blender's Python)."
            )
        logger.info(
            "Blender found at %s version %d.%d",
            self.blender_info["path"],
            self.blender_info["major"],
            self.blender_info["minor"],
        )
        self.launch_info = None

    def _addresses(self):
        """One address per (socket name, instance), ports ascending.  shm
        names carry the launch nonce; respawns reuse the command line, so
        the same name, and the reader reopens the new ring generation."""
        bind = self.bind_addr
        if bind == "primaryip":
            bind = get_primary_ip()
        addresses, port = {}, self.start_port
        for name in self.named_sockets:
            addrs = []
            for idx in range(self.num_instances):
                if self.proto == "ipc":
                    path = os.path.join(tempfile.gettempdir(),
                                        f"blendjax-{name}-{port + idx}.ipc")
                    addrs.append(f"ipc://{path}")
                elif self.proto == "shm":
                    addrs.append(f"shm://{self._shm_base}-{name}-{port + idx}")
                else:
                    addrs.append(f"tcp://{bind}:{port + idx}")
            port += self.num_instances
            addresses[name] = addrs
        return addresses

    def _unlink_shm(self):
        """Remove every shm object under this launch's prefix: a SIGKILLed
        producer never runs its own unlink."""
        if self.proto != "shm":
            return
        from blendjax_torch.btt.shm_rpc import unlink_base

        removed = unlink_base(self._shm_base)
        if removed:
            logger.debug("swept %d shm objects under %s", len(removed), self._shm_base)

    def _unlink_instance_shm(self, idx):
        """Sweep one instance's shm objects before it is replaced.  A live
        reader of a swept ring sees it vanish and reopens the respawn's
        fresh generation."""
        if self.proto != "shm" or self.launch_info is None:
            return
        from blendjax_torch.btt.shm_rpc import unlink_base

        for addrs in self.launch_info.addresses.values():
            if addrs[idx].startswith("shm://"):
                unlink_base(addrs[idx][len("shm://"):])

    def __enter__(self):
        if self.launch_info is not None:
            raise RuntimeError("Already launched.")

        addresses = self._addresses()

        seed = self.seed
        if seed is None:
            seed = int(np.random.randint(np.iinfo(np.int32).max - self.num_instances))
        seeds = [seed + i for i in range(self.num_instances)]

        popen_kwargs = popen_group_kwargs()
        env = child_env()
        processes, commands = [], []
        try:
            for idx in range(self.num_instances):
                script_args = [
                    "-btid",
                    str(idx),
                    "-btseed",
                    str(seeds[idx]),
                    "-btsockets",
                    *[f"{name}={addrs[idx]}" for name, addrs in addresses.items()],
                    *self.instance_args[idx],
                ]
                cmd = [str(self.blender_info["path"])]
                if self.scene:
                    cmd.append(str(self.scene))
                if self.background:
                    cmd.append("--background")
                cmd += ["--python-use-system-env", "--python", str(self.script), "--"]
                cmd += script_args

                p = subprocess.Popen(cmd, shell=False, env=env, **popen_kwargs)
                processes.append(p)
                commands.append(list(cmd))
                logger.info("Started instance %d: %s", idx, " ".join(cmd))
        except Exception:
            for p in processes:
                self._stop_process(p)
            self._unlink_shm()
            raise

        self.launch_info = LaunchInfo(addresses, commands, processes=processes)
        return self

    def respawn(self, idx):
        """Respawn instance ``idx`` with its original command line (same
        addresses, same seed: shm names carry the launch nonce); used by
        :class:`~blendjax_torch.btt.watchdog.FleetWatchdog` restarts, and
        callable directly for manual healing.  Returns the new process."""
        info = self.launch_info
        if info is None:
            raise RuntimeError("Not launched.")
        # the dead incarnation ran no cleanup (SIGKILL): sweep its shm
        # objects before the respawn recreates them
        self._unlink_instance_shm(idx)
        new = subprocess.Popen(info.commands[idx], shell=False, env=child_env(),
                               **popen_group_kwargs())
        info.processes[idx] = new
        logger.info("Respawned instance %d as pid %d", idx, new.pid)
        return new

    def assert_alive(self):
        """Raise RuntimeError if any launched process has exited (a no-op
        before the launch)."""
        if self.launch_info is None:
            return
        codes = [p.poll() for p in self.launch_info.processes]
        if any(c is not None for c in codes):
            raise RuntimeError(f"Blender instance(s) died; exit codes {codes}")

    def wait(self):
        """Block until every launched process terminates."""
        for p in self.launch_info.processes:
            p.wait()

    def __exit__(self, exc_type, exc_value, exc_traceback):
        for p in self.launch_info.processes:
            self._stop_process(p)
        remaining = [p for p in self.launch_info.processes if p.poll() is None]
        self._unlink_shm()
        self.launch_info = None
        if remaining:
            raise RuntimeError("Not all Blender instances closed.")
        logger.info("Blender instances closed")
        return False

    def _stop_process(self, p):
        """terminate -> (grace) -> kill, addressed to the process group."""
        if p.poll() is not None:
            return
        try:
            if os.name == "posix" and os.getpgid(p.pid) != os.getpgrp():
                os.killpg(os.getpgid(p.pid), _signal.SIGTERM)
            else:
                p.terminate()
        except (ProcessLookupError, PermissionError):
            p.terminate()
        try:
            p.wait(timeout=self.shutdown_grace)
        except subprocess.TimeoutExpired:
            logger.warning("Instance pid=%d ignored SIGTERM; killing.", p.pid)
            try:
                if os.name == "posix" and os.getpgid(p.pid) != os.getpgrp():
                    os.killpg(os.getpgid(p.pid), _signal.SIGKILL)
                else:
                    p.kill()
            except (ProcessLookupError, PermissionError):
                p.kill()
            p.wait()
