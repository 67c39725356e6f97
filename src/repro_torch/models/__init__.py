"""The LM substrate of the port (the dense, MoE, VLM, SSM, hybrid and
enc-dec families): layers, attention, the MoE layer, the RWKV6 and Mamba2
blocks, the model stack and its batches.  Counterpart of ``repro.models``."""
