"""Serving drivers of the port."""
