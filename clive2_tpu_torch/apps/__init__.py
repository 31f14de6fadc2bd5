"""The port's command-line apps: ``render`` (a still) and ``movie`` (a
turntable)."""
