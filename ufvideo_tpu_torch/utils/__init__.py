"""Host utilities: logging and tracing."""
