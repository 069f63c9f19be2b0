"""Drivers of the timed paths, one module per kind of traffic."""
