"""Producer-side defaults."""

#: Default socket timeout inside Blender.  Shorter than the consumer side:
#: a stuck producer should fail fast rather than stall the animation loop.
DEFAULT_TIMEOUTMS = 5000
