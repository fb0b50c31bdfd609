"""Modeled fabric constants and KV tiering of the port."""
