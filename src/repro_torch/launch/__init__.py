"""Launchers: the LM serving driver."""
