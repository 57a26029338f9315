"""Observability service (reference service/service.go:26-58), the port's
copy of the JAX package's ``service``."""

from .service import Service

__all__ = ["Service"]
