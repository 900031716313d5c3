"""Individual and read simulators."""
