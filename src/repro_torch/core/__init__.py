"""Core of the port: matcher, cover, grounding, drivers and pipeline."""
