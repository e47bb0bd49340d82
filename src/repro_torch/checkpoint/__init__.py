"""Checkpoints of the port: atomic save, keep-K GC, restore (:mod:`.checkpointer`)."""
