"""Host-side data ingest and batch assembly (numpy/scipy)."""
