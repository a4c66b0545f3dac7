"""Client side: the local trainer."""
