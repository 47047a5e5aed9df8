"""Offline data preparation tools of the port."""
