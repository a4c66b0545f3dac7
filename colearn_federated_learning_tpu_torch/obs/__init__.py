"""Observability of the port on the card: ``obs/profile.py`` traces
rounds with ``torch.profiler``."""
