"""Host-side fault tolerance shared by the port's serving tiers (see
``fault.py``)."""
