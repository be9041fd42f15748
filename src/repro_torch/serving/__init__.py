"""Serving stack of the port: paged-KV engine, scheduler, speculation."""
