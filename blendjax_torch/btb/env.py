"""Producer-side environment layer: a copy of ``blendjax.btb.env``.

``BaseEnv`` is the gym.Env analog for Blender: because Blender's animation
system is the event loop, an env implements three hooks instead of one
``step``:

- ``_env_reset()``              — restore initial state (pre_animation)
- ``_env_prepare_step(action)`` — apply the action *before* the frame so
  physics integrates it (pre_frame)
- ``_env_post_step()``          — gather ``{obs, reward, done, ...}`` after
  the frame completed (post_frame)

``RemoteControlledAgent`` bridges this callback world to a blocking remote
``step()/reset()`` peer (:class:`blendjax_torch.btt.env.RemoteEnv`, or the
pipelined :class:`blendjax_torch.btt.envpool.EnvPool`) via a REP socket:
one remote ``step()`` == one simulated frame.  With ``real_time=True`` the
socket goes non-blocking and simulation time advances even when the agent
is slow (missed frames step with no action).

Requests stamped with a correlation id (``wire.BTMID_KEY``) get the id
echoed in the reply, and a re-sent request carrying the id of a step
already served is answered from the ``wire.REPLY_CACHE_DEPTH``-deep reply
cache instead of simulating the frame twice: the consumer-side retry of a
non-idempotent ``step`` is exactly-once.  Unstamped requests behave as
before.  Requests carrying a span context (``wire.SPAN_KEY``) get one
``producer_step`` span back on the reply under ``wire.SPANS_KEY``.

The wire protocol is the JAX package's, byte for byte: a port producer
serves a ``blendjax`` consumer and the other way round.  Module import
needs no bpy; only instantiating ``BaseEnv`` touches the animation system.
"""

from __future__ import annotations

from collections import OrderedDict

import zmq

from blendjax_torch import wire
from blendjax_torch.btb.constants import DEFAULT_TIMEOUTMS


class BaseEnv:
    """Abstract Blender environment driven by animation callbacks.

    Params
    ------
    agent: callable
        ``cmd, action = agent(env, **ctx)`` invoked each frame (from the
        second frame of an episode on); ``ctx`` holds at least
        ``obs/reward/done/prev_action/time``.
    """

    STATE_INIT = "init"
    STATE_RUN = "run"
    CMD_RESTART = "restart"
    CMD_STEP = "step"

    def __init__(self, agent):
        from blendjax_torch.btb.animation import AnimationController

        self.events = AnimationController()
        self.events.pre_animation.add(self._pre_animation)
        self.events.pre_frame.add(self._pre_frame)
        self.events.post_frame.add(self._post_frame)
        self.agent = agent
        self.ctx = None
        self.renderer = None
        self.render_every = None
        self.frame_range = None
        self.state = BaseEnv.STATE_INIT

    def run(self, frame_range=None, use_animation=True):
        """Enter the env loop.  The playback range end is pinned far past
        the scene range so episodes may outlive it; ``frame_range`` only
        determines the ``done`` horizon."""
        from blendjax_torch.btb.animation import AnimationController

        self.frame_range = AnimationController.setup_frame_range(frame_range)
        self.events.play(
            (self.frame_range[0], 2147483647),
            num_episodes=-1,
            use_animation=use_animation,
            use_offline_render=True,
        )

    def attach_default_renderer(self, every_nth=1):
        """Render every nth frame into ``ctx['rgb_array']`` for a remote
        ``env.render()``: the scene camera through the offscreen renderer,
        color-managed."""
        from blendjax_torch.btb.camera import Camera
        from blendjax_torch.btb.offscreen import OffScreenRenderer

        self.renderer = OffScreenRenderer(camera=Camera(), mode="rgb", gamma=True)
        self.render_every = every_nth

    def attach_param_channel(self, channel, apply=None):
        """Receive mid-training scene-parameter pushes (the densityopt
        receiver as a hook).

        ``channel`` is any object with ``recv(timeoutms=0)`` returning a
        message dict or None (the producer side of a duplex channel,
        ROADMAP Queue 1, item 4); every frame, queued
        messages are drained non-blocking (``recv(timeoutms=0)``) and
        each is handed to ``apply`` (or the :meth:`_env_apply_params`
        hook), so a push lands within one frame of arriving and a
        silent channel costs one poll per frame.  Messages apply BEFORE
        the next action is integrated (the poll runs ahead of the
        agent callback in the frame), so a pushed physics rate or scene
        param takes effect on the very next simulated step."""
        self.param_channel = channel
        self._param_apply = apply
        # ahead of the agent callback registered in __init__: params
        # must apply before the frame's action is prepared
        self.events.pre_frame.add_first(self._poll_params)

    def _poll_params(self):
        chan = getattr(self, "param_channel", None)
        if chan is None:
            return
        while True:
            msg = chan.recv(timeoutms=0)
            if msg is None:
                break
            fn = getattr(self, "_param_apply", None)
            (fn or self._env_apply_params)(msg)

    # -- animation callbacks ------------------------------------------------

    def _pre_animation(self):
        self.state = BaseEnv.STATE_INIT
        self.ctx = {"prev_action": None, "done": False}
        self._env_reset()

    def _pre_frame(self):
        self.ctx["time"] = self.events.frameid
        self.ctx["done"] |= self.events.frameid >= self.frame_range[1]
        if self.events.frameid > self.frame_range[0]:
            cmd, action = self.agent(self, **self.ctx)
            if cmd == BaseEnv.CMD_RESTART:
                self._restart()
            elif cmd == BaseEnv.CMD_STEP:
                if action is not None:
                    self._env_prepare_step(action)
                    self.ctx["prev_action"] = action
                self.state = BaseEnv.STATE_RUN

    def _post_frame(self):
        self._render(self.ctx)
        self.ctx = {**self.ctx, **self._env_post_step()}

    def _render(self, ctx):
        if self.renderer is not None:
            offset = self.events.frameid - self.frame_range[0]
            if offset % self.render_every == 0:
                ctx["rgb_array"] = self.renderer.render()

    def _restart(self):
        self.events.rewind()

    # -- to be implemented by concrete envs ---------------------------------

    def _env_reset(self):
        """Reset state to initial; returns nothing."""
        raise NotImplementedError

    def _env_prepare_step(self, action):
        """Apply ``action`` before the frame simulates."""
        raise NotImplementedError

    def _env_post_step(self):
        """Return ``{obs, reward, ...}`` (and optionally ``done``) after the
        frame completed."""
        raise NotImplementedError

    def _env_apply_params(self, msg):
        """Apply one mid-training parameter push received over the
        attached duplex channel (:meth:`attach_param_channel`) — a
        message dict, typically ``{"cmd": "scenario", "scenario":
        name, "params": {...}}``.  Default: no-op, so envs that never
        randomize pay nothing for the hook; an env that does overrides
        it and applies what it understands."""


class RemoteControlledAgent:
    """REP-socket agent: requests from a remote peer drive the env.

    State machine per frame callback: in REP state, send the previous frame's ctx (the reply to the last
    RPC); then in REQ state, receive ``{cmd: 'reset'|'step', action}`` and
    translate to ``CMD_RESTART``/``CMD_STEP``.  A ``reset`` arriving while
    the env is already freshly reset recurses to serve the follow-up
    request immediately (so remote ``reset()`` returns the initial obs
    without consuming a frame).

    Params
    ------
    address: str
        Endpoint to bind (from ``-btsockets GYM=...``).
    real_time: bool
        Non-blocking mode: simulation never waits; missed exchanges step
        with ``action=None``.
    timeoutms: int
        Socket send/recv timeout.
    """

    STATE_REQ = "await_request"
    STATE_REP = "send_reply"

    #: replies kept for duplicate suppression — must cover the consumer's
    #: whole in-flight window (its pipeline depth), since a retry can
    #: target any outstanding request, not just the newest.  Shared with
    #: the consumer via ``wire`` so ``EnvPool`` can refuse a
    #: ``pipeline_depth`` that outruns the window.  Kept small: cached
    #: replies hold full payloads (rgb_array included), so this bounds
    #: producer-side memory at depth * frame size
    REPLY_CACHE_DEPTH = wire.REPLY_CACHE_DEPTH

    def __init__(self, address, real_time=False, timeoutms=DEFAULT_TIMEOUTMS):
        self._ctx = zmq.Context.instance()
        self.socket = self._ctx.socket(zmq.REP)
        self.socket.setsockopt(zmq.LINGER, 0)
        self.socket.setsockopt(zmq.SNDTIMEO, timeoutms)
        self.socket.setsockopt(zmq.RCVTIMEO, timeoutms)
        self.socket.bind(address)
        self.real_time = real_time
        self.state = RemoteControlledAgent.STATE_REQ
        # correlation-id bookkeeping: _pending_mid rides the request being
        # simulated; once its reply goes out it joins _reply_cache
        # (mid -> reply) for duplicate suppression.  A pipelined consumer
        # (EnvPool pipeline_depth > 1) may retry ANY of its in-flight
        # requests — its oldest expired first — so the cache must cover
        # the whole window, not just the newest reply; REPLY_CACHE_DEPTH
        # comfortably exceeds any sane pipeline depth.
        self._pending_mid = None
        self._reply_cache = OrderedDict()
        self._dup_reply = None  # cached reply owed after a NOBLOCK Again
        # span context of the request being simulated: (trace id,
        # receipt time in epoch us); rides into the reply as a
        # producer-side span when the request asked for one
        self._pending_span = None

    def __call__(self, env, **ctx):
        flags = 0
        if self.real_time and env.state == BaseEnv.STATE_RUN:
            flags = zmq.NOBLOCK

        if self._dup_reply is not None:
            # a duplicate request consumed last frame is still owed its
            # cached reply (REP alternation): flush before anything else
            try:
                wire.send_message(self.socket, self._dup_reply, flags=flags)
                self._dup_reply = None
            except zmq.Again:
                if not self.real_time:
                    raise TimeoutError(
                        "Failed to re-send cached reply to remote agent."
                    ) from None
                return BaseEnv.CMD_STEP, None

        if self.state == RemoteControlledAgent.STATE_REP:
            reply = ctx
            if self._pending_mid is not None:
                reply = {**ctx, wire.BTMID_KEY: self._pending_mid}
            if self._pending_span is not None:
                from blendjax_torch.obs.spans import make_span

                trace, t0_us = self._pending_span
                reply = dict(reply)
                reply[wire.SPANS_KEY] = [make_span(
                    "producer_step", t0_us, trace=trace, cat="producer",
                )]
            try:
                wire.send_message(self.socket, reply, flags=flags)
                self.state = RemoteControlledAgent.STATE_REQ
                if self._pending_mid is not None:
                    self._reply_cache[self._pending_mid] = reply
                    while len(self._reply_cache) > self.REPLY_CACHE_DEPTH:
                        self._reply_cache.popitem(last=False)
                    self._pending_mid = None
                self._pending_span = None
            except zmq.Again:
                if not self.real_time:
                    raise TimeoutError("Failed to send reply to remote agent.")
                return BaseEnv.CMD_STEP, None

        while True:
            try:
                request = self.socket.recv(flags=flags)
            except zmq.Again:
                return BaseEnv.CMD_STEP, None
            request = wire.loads(request)
            mid = request.get(wire.BTMID_KEY)
            if mid is not None and mid in self._reply_cache:
                # consumer retry of a step already simulated: serve the
                # cached reply (exactly-once) and await the real next
                # request.  The send is safe mid-cycle — REP queues to
                # (or discards for) the requesting peer; under real_time
                # a full pipe stashes the owed reply for the next frame
                # instead of raising inside Blender's frame callback.
                try:
                    wire.send_message(
                        self.socket, self._reply_cache[mid], flags=flags
                    )
                except zmq.Again:
                    if not self.real_time:
                        raise TimeoutError(
                            "Failed to re-send cached reply to remote agent."
                        ) from None
                    self._dup_reply = self._reply_cache[mid]
                    return BaseEnv.CMD_STEP, None
                continue
            break
        cmd_name = request.get("cmd")
        if cmd_name not in ("reset", "step"):
            raise ValueError(f"unknown remote command {cmd_name!r}")
        self.state = RemoteControlledAgent.STATE_REP
        self._pending_mid = mid
        span_ctx = request.get(wire.SPAN_KEY)
        if isinstance(span_ctx, dict) and span_ctx.get("trace") is not None:
            from blendjax_torch.obs.spans import now_us

            self._pending_span = (span_ctx["trace"], now_us())
        else:
            self._pending_span = None

        if cmd_name == "reset":
            if env.state == BaseEnv.STATE_INIT:
                # Already reset: reply with the fresh ctx and serve the
                # follow-up request in the same frame.
                return self.__call__(env, **ctx)
            return BaseEnv.CMD_RESTART, None
        return BaseEnv.CMD_STEP, request.get("action")

    def close(self):
        self.socket.close(0)
