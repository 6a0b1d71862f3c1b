"""Padding helpers (``pointcloudhookup_tpu/core/batch.py`` imports jax, so
the one helper the port needs is copied here)."""

from __future__ import annotations


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple
