"""The port's parallel layer: so far the one-device record sort."""
