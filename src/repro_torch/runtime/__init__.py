"""Serving runtime: the decode server with snapshots."""
