"""Core of the port: index, k-means, scheduler, routing templates, locks."""
