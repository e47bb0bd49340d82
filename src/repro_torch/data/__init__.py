"""Synthetic bibliographic corpora (the port's copy of ``repro.data.synthetic``)."""
