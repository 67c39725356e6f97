"""Serving of the port: prefill / decode steps and the RAG path that splices
retrieved memories into the prompt.  Counterpart of ``repro.serving``."""
