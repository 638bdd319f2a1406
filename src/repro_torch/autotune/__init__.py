"""Exit telemetry helpers (the rest of the autotune stack comes with its
own slice of the port)."""
