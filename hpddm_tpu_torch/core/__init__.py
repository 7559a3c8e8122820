"""Host CSR container and batched device formats."""
