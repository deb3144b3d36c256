"""Animation-driven producer event loop, a copy of
``blendjax.btb.animation``.

**Blender's animation system is the event loop**: producer work happens
inside callbacks Blender invokes around each frame; nothing here spins its
own loop except the blocking fallback for ``--background`` mode.

Signals (invoked in this order over a play of E episodes x F frames)::

    pre_play
      [ pre_animation  (pre_frame post_frame) x F  post_animation ] x E
    post_play

Two modes:

- ``use_animation=True`` (UI): non-blocking.  Hooks
  ``frame_change_pre``; ``post_frame`` fires either from a ``POST_PIXEL``
  draw handler (GL context valid there, as offscreen rendering needs) or
  from ``frame_change_post``.  Playback advances via
  ``bpy.ops.screen.animation_play``.
- ``use_animation=False`` (``--background``): a blocking loop stepping
  ``frame_set``, which synchronously fires the same handlers.

``POST_PIXEL`` may fire several times per frame; a pending/last-frame guard
dedupes.  ``bpy`` is imported where it is used, not when the module is: the
module imports anywhere, and under the fake Blender it binds the ``bpy``
installed at the time of the call.
"""

from __future__ import annotations

import sys

from blendjax_torch.btb.signal import Signal


def _bpy():
    import bpy

    return bpy


def _find_first_view3d():
    """First VIEW_3D area's space: where the POST_PIXEL handler draws."""
    bpy = _bpy()
    areas = [a for a in bpy.context.screen.areas if a.type == "VIEW_3D"]
    if not areas:
        raise RuntimeError("No VIEW_3D area found; offscreen rendering needs a UI.")
    spaces = [s for s in areas[0].spaces if s.type == "VIEW_3D"]
    if not spaces:
        raise RuntimeError("VIEW_3D area lacks a VIEW_3D space.")
    return spaces[0]


class _Playback:
    """Per-play bookkeeping."""

    def __init__(self, frame_range, num_episodes, use_animation, use_offline_render):
        self.frame_range = frame_range
        self.num_episodes = num_episodes
        self.use_animation = use_animation
        self.use_offline_render = use_offline_render
        self.episode = 0
        self.pending_post_frame = False
        self.last_post_frame = None
        self.draw_handler = None
        self.draw_space = None


class AnimationController:
    """Fine-grained callbacks around Blender's animation playback."""

    def __init__(self):
        self.pre_play = Signal()
        self.pre_animation = Signal()
        self.pre_frame = Signal()
        self.post_frame = Signal()
        self.post_animation = Signal()
        self.post_play = Signal()
        self._pb = None

    @property
    def frameid(self):
        """Current scene frame."""
        return _bpy().context.scene.frame_current

    @property
    def playing(self):
        return self._pb is not None

    @staticmethod
    def setup_frame_range(frame_range=None, physics=True):
        """Apply (start, end) inclusive to the scene and, when ``physics``,
        to the rigid-body point cache so simulation covers the animation
        range."""
        scene = _bpy().context.scene
        if frame_range is None:
            frame_range = (scene.frame_start, scene.frame_end)
        scene.frame_start, scene.frame_end = frame_range
        if physics and getattr(scene, "rigidbody_world", None):
            cache = scene.rigidbody_world.point_cache
            cache.frame_start, cache.frame_end = frame_range
        return frame_range

    def play(
        self,
        frame_range=None,
        num_episodes=-1,
        use_animation=True,
        use_offline_render=True,
        use_physics=True,
    ):
        """Start playback.

        Params
        ------
        frame_range: (start, end) inclusive | None
            Defaults to the scene's range.
        num_episodes: int
            Loops to play; -1 plays forever.
        use_animation: bool
            True: non-blocking via Blender's player (UI responsive, target
            FPS).  False: blocking loop, as fast as possible (background).
        use_offline_render: bool
            Route ``post_frame`` through a POST_PIXEL draw handler so
            offscreen rendering is safe inside it.
        use_physics: bool
            Sync the rigid-body cache to the frame range.
        """
        if self._pb is not None:
            raise RuntimeError("Animation already running")
        self._pb = _Playback(
            frame_range=AnimationController.setup_frame_range(
                frame_range, physics=use_physics
            ),
            num_episodes=num_episodes if num_episodes >= 0 else sys.maxsize,
            use_animation=use_animation,
            use_offline_render=use_offline_render,
        )
        self.pre_play.invoke()
        if use_animation:
            self._start_nonblocking()
        else:
            self._run_blocking()

    def _start_nonblocking(self):
        bpy = _bpy()
        bpy.app.handlers.frame_change_pre.append(self._handle_pre_frame)
        if self._pb.use_offline_render:
            self._pb.draw_space = _find_first_view3d()
            self._pb.draw_handler = bpy.types.SpaceView3D.draw_handler_add(
                self._handle_post_frame, (), "WINDOW", "POST_PIXEL"
            )
        else:
            bpy.app.handlers.frame_change_post.append(self._handle_post_frame)
        bpy.context.scene.frame_set(self._pb.frame_range[0])
        bpy.ops.screen.animation_play()

    def _run_blocking(self):
        bpy = _bpy()
        bpy.app.handlers.frame_change_pre.append(self._handle_pre_frame)
        bpy.app.handlers.frame_change_post.append(self._handle_post_frame)
        start, end = self._pb.frame_range
        while self._pb is not None and self._pb.episode < self._pb.num_episodes:
            bpy.context.scene.frame_set(start)
            while self._pb is not None and self.frameid < end:
                bpy.context.scene.frame_set(self.frameid + 1)
            # _handle_post_frame may have called stop() -> _pb is None

    def rewind(self):
        """Jump back to the first frame of the range."""
        if self._pb is not None:
            _bpy().context.scene.frame_set(self._pb.frame_range[0])

    def stop(self):
        """Stop playback, unregister handlers, fire ``post_play``."""
        if self._pb is None:
            return
        bpy = _bpy()
        pb = self._pb
        bpy.app.handlers.frame_change_pre.remove(self._handle_pre_frame)
        if pb.draw_handler is not None:
            bpy.types.SpaceView3D.draw_handler_remove(pb.draw_handler, "WINDOW")
            pb.draw_handler = None
        else:
            bpy.app.handlers.frame_change_post.remove(self._handle_post_frame)
        if pb.use_animation:
            bpy.ops.screen.animation_cancel(restore_frame=False)
        self._pb = None
        self.post_play.invoke()

    # -- frame callbacks ----------------------------------------------------

    def _handle_pre_frame(self, scene, *args):
        if self._pb is None:
            return
        if self.frameid == self._pb.frame_range[0]:
            self.pre_animation.invoke()
        self.pre_frame.invoke()
        self._pb.pending_post_frame = True

    def _skip_post_frame(self):
        """POST_PIXEL dedupe: only the first draw after a pre_frame, once
        per frame, and only for the hooked space."""
        pb = self._pb
        return (
            not pb.pending_post_frame
            or pb.last_post_frame == self.frameid
            or (
                pb.use_animation
                and pb.use_offline_render
                and _bpy().context.space_data != pb.draw_space
            )
        )

    def _handle_post_frame(self, *args):
        if self._pb is None or self._skip_post_frame():
            return
        self._pb.pending_post_frame = False
        self._pb.last_post_frame = self.frameid

        self.post_frame.invoke()
        if self.frameid == self._pb.frame_range[1]:
            self.post_animation.invoke()
            self._pb.episode += 1
            if self._pb.episode >= self._pb.num_episodes:
                self.stop()
