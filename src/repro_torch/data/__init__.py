"""The training data pipeline (a copy of ``repro.data``)."""
