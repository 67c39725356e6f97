"""Training of the port: AdamW on f32 master weights, the train step with
grad accumulation and compression, and the fault-tolerant `Trainer`.
Counterpart of ``repro.train``."""
