"""Launchers: the serving entry point (``launch.serve``)."""
