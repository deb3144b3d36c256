"""Consumer-side defaults."""

#: Default socket timeout on the training host.  Generous: Blender instances
#: can take several seconds to boot and compile shaders before first frame.
DEFAULT_TIMEOUTMS = 10000
