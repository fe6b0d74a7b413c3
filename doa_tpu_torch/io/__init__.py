"""Ingest helpers of the port."""
