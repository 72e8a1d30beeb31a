"""Multi-tenant HTTP search server (reference seekstorm_server analog)."""

from .app import SearchServer, start_server  # noqa: F401
