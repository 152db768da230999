"""Synthetic federated image data (numpy copies of ``repro.data``)."""
