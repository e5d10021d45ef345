"""Utility types shared across the package."""

from .itemset import ItemSet

__all__ = ["ItemSet"]
