"""The LM substrate of the port (dense family): layers, attention, the
model stack and its batches.  Counterpart of ``repro.models``."""
