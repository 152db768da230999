"""Tree helpers keyed by the reference's leaf paths."""
