"""Shared error types (reference: common/rolling_list.go:20-24, hashgraph/store.go:20-23)."""


class KeyNotFoundError(KeyError):
    """Requested item is not present in the store/cache."""


class TooLateError(KeyError):
    """Requested item has been evicted from the bounded history window.

    The reference returns ErrTooLate when a peer asks for events older than
    the RollingList window (hashgraph/caches.go:59-61); disk spill was left
    unimplemented there.  We raise the same condition so callers can trigger
    a catch-up path.
    """
