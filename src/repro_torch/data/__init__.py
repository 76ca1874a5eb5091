"""Synthetic datasets and vertical partitioning (numpy)."""
