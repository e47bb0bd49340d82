"""Launchers: the LM serving driver (and ``--em``, the sharded EM service), and
the EM service mesh and sharding policy."""
