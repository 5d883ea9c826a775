"""REST web service (reference: svc-src/ OpenResty Lua service)."""

from .app import SearchService, main

__all__ = ["SearchService", "main"]
