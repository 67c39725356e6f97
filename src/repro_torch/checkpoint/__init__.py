"""Atomic, async checkpoints of the port (see ``checkpointer.py``)."""
