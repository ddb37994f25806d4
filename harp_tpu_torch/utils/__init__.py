"""Host-side helpers: comm ledger and spans, device sync and timing, metrics."""
