"""Packed sparse payloads (bitmap + nnz values) and the ops that fold them."""
