"""Round engines."""
