"""The harness: cells, the system under test, the trace and the check."""
