"""Storage layer: the Database container, transactions, and persistence."""

from .database import Database, IndexState, Metadata, ReadTxn, WriteTxn

__all__ = ["Database", "IndexState", "Metadata", "ReadTxn", "WriteTxn"]
