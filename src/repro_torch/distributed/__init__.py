"""Host-side fault tolerance shared by the port's serving and training
tiers (``fault.py``), gradient compression (``collectives.py``) and
elastic restarts (``elastic.py``)."""
