"""Tiny name→factory registry used by the model zoo and dataset registry."""

from __future__ import annotations

from typing import Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable] = {}

    def register(self, name: str):
        def deco(fn):
            if name in self._entries:
                raise ValueError(f"duplicate {self.kind} registration: {name!r}")
            self._entries[name] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; known: {sorted(self._entries)}"
            ) from None

    def names(self):
        return sorted(self._entries)
